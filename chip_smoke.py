#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (quip_for_all_tpu_torch) on one CUDA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result
line):
  1. the card (nvidia-smi name and power limit) and the kernels' build from
     the repo's sources (one nvcc per source, all started together);
  2. fused_decode_matmul (K1, the tensor-core body at m <= 32) against
     its plain torch twin at the Llama-2-7B shapes of the main path, m =
     1, 8, 16 and 32 with one plane set and m = 1 and 32 with two, and
     Mixtral's GQA qkv at m = 1, with times on the card (CUDA-graph
     replays, L2-cold), the plain twin's time, the bound from
     device-memory bytes at 3.35 TB/s, and a library yardstick (one dense
     bf16 product of the same shape); sums per token (m = 1, 8) and per
     prefill (m = 16, 32);
  3. moe_decode_matmul (K4/K5, K1's tensor-core body with a row map by
     expert) against its plain twin at Mixtral-8x7B's w13 and w2 shapes
     with 8 experts, R = 2 (bs=1 decode), 16 and 62 rows (top-2 over 8
     and 31 tokens), timed the same way in bf16; also held to the twin,
     untimed, in f32 at R = 2 and with 2 plane sets at R = 16;
  4. the golden reference-schema checkpoint through the kernel (f32);
  5. the main path: Llama-2-7B E8P12 (random codes, seed 0), fused qkv and
     gate/up, quantized head, cache_len 2048, bs=1: a 32-token prompt and
     128 greedy tokens through ``generate`` (its decode steps replayed as
     one CUDA graph per attention bucket), twice, with kernel launch
     counts (a replay adds what its capture recorded), the first 16
     tokens held against the same path with every linear on the plain
     twin (both as eager step loops), and the device time of one decode
     step and of the 32-token prefill (CUDA-graph replays); then on the
     same model (a) ``generate`` by the host clock over the whole call,
     graphed beside the eager step loop and bitwise equal to it, a
     240-token prompt across the 256 bucket (two graphs),
     ``generate_stream`` in chunks of 8 and the int8 KV cache against the
     bf16 cache; (b) ``ServingEngine``, 8 slots, 16 requests from seed 0
     (prompts 16-512, 32-128 new tokens), chunked prefill of 128: tok/s,
     time to first token, inter-token time, each graph's device time, and
     4 requests in f32 held to f32 ``generate``; (e) ``torch.profiler``
     over one eager decode step, and over one shaped as serving's at 8
     slots (bucket 1024): device time by kernel and by model part;
     (d) the CLIs ``cli.generate`` and ``cli.eval_ppl`` on the golden
     checkpoint; each with exact launch counts;
  6. the Mixtral path: Mixtral-8x7B E8P12 at all 32 layers (random codes,
     seed 0, experts stacked, fused qkv, quantized head), the same
     prompt/greedy runs with 64 new tokens, exact launch counts of both
     kernels, a 16-token prompt through the sparse prefill, and the
     kernel-vs-plain check with the kernel run on the plain run's top-2
     routing (a fork accepted only at a near-tie of the tokens), the
     device time of the 16-token sparse prefill (CUDA-graph replay), and
     (c) ``ServingEngine`` at 4 slots, 4 requests of 16 new tokens
     (dense expert loop in the prefill, K4 in decode);
  7. the row-pair kernels (u3 and pb, each its codes policy on the
     tensor-core body ucode_mma_small.cuh) against their plain twins at
     the Llama-2-7B shapes, m = 1, 8, 32 and 64 in bf16 and m = 1 in f32
     (gx in bf16 above 8 rows), timed as in phase 2, each beside
     fused_decode_matmul on the nibble planes of the same codes (E8P12 1
     plane for u3, E8P12RVQ4B 2 planes for pb), with sums per token (m =
     1, 8) and per prefill (m = 32, 64);
  8. the golden fixtures in the byte-cut layouts: e8p12 as u3, e8p12rvq4b
     as nibble and as pb;
  9. the byte-cut paths at full width, all 32 layers, random codes from
     seed 0: (a) Llama-2-7B E8P12 in u3 and (b) E8P12RVQ4B in pb through
     the row-pair kernels, (c) E8P12RVQ4B in nibble through
     fused_decode_matmul with 2 plane sets; each a 32-token prompt and 32
     greedy tokens twice, exact launch counts, one graphed step, the
     graphed 32-token prefill, and the kernel-vs-plain check over 16
     tokens;
 10. bfp_decode_matmul (K10, K1's tensor-core body on row-pair words, 1
     and 2 plane sets), sw_decode_matmul (K11, sw2 and sw4), ksplit_decode_matmul
     (K6, K1's tensor-core body over (tile, chunk) units and a reduce where
     the split pays, else over whole tiles; 2 and 4 chunks;
     down 11) and paired_decode_matmul (K7) against their plain twins at
     the Llama-2-7B shapes, m = 1, 8, 32, 64 in bf16 and 1 in f32, timed
     as in phase 2, beside fused_decode_matmul on the same codes (and K7
     beside pb), with sums per token (m = 1, 8) and per prefill (m = 32,
     64), and the I2F count of every built library's SASS (phase 1);
 11. the golden fixtures in the new layouts: e8p12 as bfp, sw2 and sw4,
     e8p12rvq4b as paired and bfp;
 12. the new paths at full width, all 32 layers, right after phase 5 on
     its model: (f) split-K = 4 on the main path's planes, (e) those
     planes re-laid as sw4 and (d) as bfp, each first held to phase 5's
     f32 logits, then (g) E8P12RVQ4B paired from seed 0; each as in phase
     9 (the graphed 32-token prefill too), with the exact launch counts of
     its kernels;
 13. fused_decode_matmul_bwd (K3, the tensor-core backward of K1/K2)
     against its plain twin at Llama-2-7B's unfused shapes (q/k/v/o,
     gate/up, down, head), m = 1, 64 and 1022, bf16 and f32, 1 and 2 plane
     sets, timed as in phase 2 beside the library product gs @ W; then the
     backward of the copy layouts (u3, bfp, pb, paired: their planes
     re-laid to nibble words on every call) beside the nibble layout's at
     m = 1022;
 14. LoRA training at full width: Llama-2-7B E8P12 (random codes, seed 0,
     unfused, quantized head, all 32 layers) with rank-8 adapters on the
     7 default targets, batches of 2 x 512 tokens (1022 rows: K2 forward,
     K3 backward, no K1) with exact launch counts per step, every adapter
     gradient against the plain route in f32 and bf16, the step split
     into forward and backward with K2/K3 event times, 8 AdamW steps of
     ``train_lora`` (lr 1e-4) on one batch whose loss falls at every
     step, one step at the CLI default 4 x 512 (2044 rows, the dense
     route: no K2, no K3), and ``generate`` with the trained adapters
     through K1.
 15. the microbenchmarks T1-T5 (``quip_for_all_tpu_torch/tools``) through
     their ``run`` entry points at the tools' default shapes, m = 1 and 8,
     with every launch count reset before and read after: each variant
     held to its plain twin inside the run, timed (CUDA-graph replays,
     L2-cold) beside its byte bound, its twin and one library call of its
     own function (a bf16 product on weights decoded beforehand; for the
     load floors the row sum or the one-plane product); T4 at every
     rows-per-block value on its four shapes; T5's probe launched once,
     held bit for bit and its bitcast order printed.
 16. fused_decode_matmul_tc (K2) against its plain twin at the training
     shapes of phase 13, m = 64 and 1022, bf16 and f32, 1 and 2 plane
     sets, timed as in phase 2 beside the library product x @ W.T (W
     decoded beforehand in x's dtype); at m = 1022 and 2044 (bf16, 1 set)
     the dense route (decode_weights + torch.matmul, as quant_matmul runs
     it above FUSED_MAX_M) timed beside K2: the fused/dense crossover.
 17. the right transform's B-side factor in the kernels' epilogue
     (right_hb, ``set_right_in_kernel``) and the combined residual decode
     (``set_combine_planes``): (i) K1, K11 (sw4), K10, K6 (2 and 4
     chunks), K7, K8 and K9 with right_hb at the five Llama-2-7B linears
     (each segment's own M), m = 1, 8 and 32 in bf16 and m = 1 in f32, K2
     at m = 64 and 1022, K3's backward (g times Hb first) at m = 1022:
     each held to the same kernel without it followed by the torch
     product, and to its plain twin; timed (bf16) beside the kernel
     without it plus the torch product; (ii) K1, K11 and K2 with the
     combined decode on E8P12RVQ4B and E8P12RVQ3B codes held to the
     twin, K1 timed combined beside split; (iii) right after 5d, the main
     path with the epilogue on: graphed ``generate`` 32 + 128 bitwise
     equal to the eager loop, f32 logits of 8 steps held to the switch-off
     run, exact launch counts (129 K1 a token), a graphed step's device
     time beside the switch-off step's, and a profiled eager step by part;
     (iv) within 9, path (c) again with both switches on (combine 8), 32
     tokens, held to its plain twin; (v) within 4, the golden d4, hi and
     e8p12rvq3b fixtures, also with the epilogue on.
 18. the other model families through ``models/registry.py``: (i)
     GPT-NeoX-20B (the published EleutherAI/gpt-neox-20b widths, all 44
     layers; E8P12 nibble, random codes from seed 0, quantized head: 177
     K1 a forward, no dense-route linear): K1 launches and dense-route
     linears per forward against the widths rule, a 32-token prompt and
     32 greedy tokens through graphed ``generate`` bitwise equal to the
     eager step loop, the kernel-vs-plain check in bf16 and f32, one
     graphed step's and the 32-token prefill's device time, K1 per token
     beside its bound at GPT-NeoX-20B's five shapes (timed as in phase
     2), and ``ServingEngine`` at 4 slots, 4 requests (prompts 16-128,
     16 new) in f32, its prefill chunks on K2, held to f32 ``generate``;
     (ii) GPT-2, OPT, Falcon, Phi, GPT-J, QWen (fused) and Baichuan (fused)
     at their published widths (``FAMILY_HF``), 2 layers each: the
     routes against the widths rule, graphed ``generate`` of 8 tokens
     against the eager loop and f32 logits against the plain route.
 19. quantization on the card (``QuipQuantizer``): (i) the dense
     Llama-2-7B-width model of ``init_llama_params`` (seed 0, QUANT_LAYERS
     layers: depth the only cut) quantized to E8P12 with 10 tune
     iterations and the head, from 32 x 512 synthetic calibration tokens,
     each linear's seconds and proxy loss printed; ``save_quantized``,
     ``load_quantized`` on the card, ``fuse_for_inference``; the f32 logits'
     relative error against the float model's on a calibration window;
     the widths rule (9 K1 a forward), graphed ``generate`` of 32 tokens
     bitwise the eager loop's with exact K1 launches, and f32 logits of 8
     steps against the plain route; (ii) a 512 x 1024 layer on the card
     against the CPU (proxy loss within 2%, codes' agreement, TF32 off in
     the call); (iii) one full-width layer with no tune iterations, the
     block and end-to-end finetune for 2 epochs (finite losses, none above
     its initial one); (iv) ``cli.quantize --model-path random:tiny
     --device cuda`` and its save run on the card; (v) one LDLQ step at
     4096 rows: the rounding (addmm + max beside matmul + sub + max,
     CUDA-graph replays, beside its bound) and 64 steps by the host clock
     and by kernel (``torch.profiler``).
Phases run in the order 1-4, 7, 10, 13, 16, 15, 17 (i, ii), 11, 5 (with
a, b, e, d), 17 (iii), 12, 6 (with c), 18, 9 (with 17 iv), 14, 19; each
logs its start and its seconds. The last
stdout line
is {"ok": true, "device": {...}}; the line before it lists the kernels
with their numbers; the line before that the card's name and power limit.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()
# quip_for_all_tpu_torch.tools._timing (the card's rates, the L2-cold
# copies, the graph timing and the kernel-vs-twin tolerance), imported in
# main once the checkout is on the path
tm = None

KERNELS = [{
    "name": "fused_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/fused_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:135",
}, {
    "name": "moe_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/moe_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/moe_pallas.py:56 (K4) and "
                "quip_for_all_tpu/ops/moe_pallas.py:91 (K5)",
}, {
    "name": "rowpair_u3_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/rowpair_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:486 (K9)",
}, {
    "name": "rowpair_pb_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/rowpair_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:566 (K8)",
}, {
    "name": "bfp_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/bfp_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:281 (K10)",
}, {
    "name": "sw_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/sw_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:135 (K11, split=2/4)",
}, {
    "name": "ksplit_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/ksplit_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:633 (K6)",
}, {
    "name": "paired_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/paired_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:356 (K7)",
}, {
    "name": "fused_decode_matmul_bwd", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/fused_decode_matmul_bwd.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:970 (K3)",
}, {
    "name": "fused_decode_matmul_tc", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/fused_decode_matmul_tc.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:888 (K2, the 2-D "
                "m-tiled grid of _make_kernel at :135)",
}, {
    "name": "mb_kernel", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/mb_kernel.cu",
    "replaces": "tools/microbench_kernel.py:80 (T1)",
}, {
    "name": "mb_decode", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/mb_decode.cu",
    "replaces": "tools/microbench_decode.py:168 (T2)",
}, {
    "name": "mb_tn", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/mb_tn.cu",
    "replaces": "tools/microbench_tn.py:73 and :102 (T4)",
}, {
    "name": "mb_bfp_probe", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/mb_bfp_probe.cu",
    "replaces": "tools/microbench_bfp.py:78 (T5)",
}]
# the byte-cut layouts: (layout, codebook, kernel); the nibble planes of
# the same codes run fused_decode_matmul with 1 (E8P12) or 2 plane sets
ROWPAIR = [("u3", "E8P12", "rowpair_u3_decode_matmul"),
           ("pb", "E8P12RVQ4B", "rowpair_pb_decode_matmul")]
RP_CASES = [(1, "bfloat16"), (8, "bfloat16"), (32, "bfloat16"),
            (64, "bfloat16"), (1, "float32")]
# fused_decode_matmul linears: (name, q_out, q_in, scale vector in the
# epilogue on the main path, rows m timed). The first five are Llama-2-7B's
# per decode token; Mixtral-8x7B shares o and head and has its own GQA qkv.
SHAPES = [("qkv", 12288, 4096, True, (1, 8, 16, 32)),
          ("o", 4096, 4096, False, (1, 8, 16, 32)),
          ("gateup", 22016, 4096, True, (1, 8, 16, 32)),
          ("down", 4096, 11008, False, (1, 8, 16, 32)),
          ("head", 32000, 4096, False, (1, 8, 16, 32)),
          ("qkv_gqa", 6144, 4096, True, (1,))]
# K1 with two plane sets (E8P12RVQ4B in nibble) at these m; the affine
# pairs of one and two sets
K1_2SETS_M = (1, 32)
K1_AFFINE = ((0.5, -2.75), (0.5 / 3.45, -2.75 / 3.45))
LAYERS = 32
# the kernel each runtime layout's linears launch
LAYOUT_KERNEL = {"u3": "rowpair_u3_decode_matmul",
                 "pb": "rowpair_pb_decode_matmul",
                 "bfp": "bfp_decode_matmul", "sw2": "sw_decode_matmul",
                 "sw4": "sw_decode_matmul", "paired": "paired_decode_matmul"}
# per token: each linear's calls (the head once, the rest once per layer)
LLAMA_CALLS = {"qkv": LAYERS, "o": LAYERS, "gateup": LAYERS,
               "down": LAYERS, "head": 1}
# split-K's calls per token on path (f): down stays on fused_decode_matmul
KSPLIT_CALLS = {"qkv": LAYERS, "o": LAYERS, "gateup": LAYERS, "head": 1}
MIXTRAL_FUSED_CALLS = {"qkv_gqa": LAYERS, "o": LAYERS, "head": 1}
# Mixtral-8x7B stacked experts: (name, q_out, q_in); R = top-2 rows of
# 1 (bs=1 decode), 8 and 31 tokens (sparse prefill below 32 tokens)
MOE_SHAPES = [("w13", 28672, 4096), ("w2", 4096, 14336)]
MOE_E, MOE_K = 8, 2
MOE_R = (2, 16, 62)
# the MoE kernel held to its twin, untimed: R -> (x's dtype, plane sets)
MOE_CHECK = {2: ("float32", 1), 16: ("bfloat16", 2)}
# K3 at Llama-2-7B's unfused linears: (name, q_out, q_in); its calls per
# LoRA training step (layer 0's q/k/v inputs need no gradient: 3*31 + 32
# of the 4096x4096 shape) and the rows of that step (batch 2 x 511)
K3_SHAPES = [("qkvo", 4096, 4096), ("gateup", 11008, 4096),
             ("down", 4096, 11008), ("head", 32000, 4096)]
K3_CALLS = {"qkvo": 3 * (LAYERS - 1) + LAYERS, "gateup": 2 * LAYERS,
            "down": LAYERS, "head": 1}
K3_M = (1, 64, 1022)
TRAIN_B, TRAIN_S = 2, 512
# K2 at the same shapes: its calls per training forward (every quantized
# linear), its rows (m = 64 is a prefill's) and the rows at which the dense
# route is timed beside it (the CLI default batch 4 x 512 is 2044 rows)
K2_CALLS = {"qkvo": 4 * LAYERS, "gateup": 2 * LAYERS, "down": LAYERS,
            "head": 1}
K2_M = (64, 1022)
DENSE_M = (1022, 2044)
# (a): the int8 KV cache's logits against the bf16 cache's, a share of
# max|logit| (int8 codes round at 1/254 of a row's max, bf16 at 2^-9 of
# each value; both then go through 32 random layers, hence the bf16
# kernel-vs-plain tolerance doubled)
INT8_TOL = 0.1
# (b): requests to the serving engine, drawn from seed 0: how many, prompt
# lengths and max_new_tokens (uniform in each range)
SERVE_N, SERVE_PROMPT, SERVE_NEW = 16, (16, 512), (32, 128)
# phase 18 (i): GPT-NeoX-20B at full width and all 44 layers: the fields of
# the published EleutherAI/gpt-neox-20b config.json that
# ModelConfig.from_hf_config reads, written here (nothing is downloaded)
NEOX_20B_HF = {"model_type": "gpt_neox", "vocab_size": 50432,
               "hidden_size": 6144, "intermediate_size": 24576,
               "num_hidden_layers": 44, "num_attention_heads": 64,
               "max_position_embeddings": 2048, "rotary_pct": 0.25,
               "rotary_emb_base": 10000, "layer_norm_eps": 1e-05,
               "use_parallel_residual": True, "tie_word_embeddings": False}
# its K1 linears (name, q_out, q_in, scale vector, rows m timed) and their
# calls per token (the head once)
NEOX_SHAPES = [("neox_qkv", 18432, 6144, False, (1, 32)),
               ("neox_dense", 6144, 6144, False, (1, 32)),
               ("neox_h_to_4h", 24576, 6144, False, (1, 32)),
               ("neox_4h_to_h", 6144, 24576, False, (1, 32)),
               ("neox_head", 50432, 6144, False, (1, 32))]
NEOX_CALLS = {name: 44 for name, *_ in NEOX_SHAPES[:4]}
NEOX_CALLS["neox_head"] = 1
# (ii): the published config.json fields of the other seven families, by
# model id; only the depth is cut, to FAMILY_LAYERS
FAMILY_HF = {
    "gpt2-xl": {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 1600,
                "n_layer": 48, "n_head": 25, "n_inner": None,
                "n_positions": 1024, "layer_norm_epsilon": 1e-05},
    "facebook/opt-6.7b": {"model_type": "opt", "vocab_size": 50272,
                          "hidden_size": 4096, "ffn_dim": 16384,
                          "num_hidden_layers": 32, "num_attention_heads": 32,
                          "max_position_embeddings": 2048,
                          "do_layer_norm_before": True,
                          "word_embed_proj_dim": 4096},
    "tiiuae/falcon-7b": {"model_type": "falcon", "vocab_size": 65024,
                         "hidden_size": 4544, "num_hidden_layers": 32,
                         "num_attention_heads": 71, "multi_query": True,
                         "parallel_attn": True,
                         "new_decoder_architecture": False,
                         "layer_norm_epsilon": 1e-05},
    "microsoft/phi-2": {"model_type": "phi", "vocab_size": 51200,
                        "hidden_size": 2560, "intermediate_size": 10240,
                        "num_hidden_layers": 32, "num_attention_heads": 32,
                        "num_key_value_heads": None,
                        "max_position_embeddings": 2048,
                        "partial_rotary_factor": 0.4, "layer_norm_eps": 1e-05,
                        "rope_theta": 10000.0, "tie_word_embeddings": False},
    "EleutherAI/gpt-j-6b": {"model_type": "gptj", "vocab_size": 50400,
                            "n_embd": 4096, "n_layer": 28, "n_head": 16,
                            "n_inner": None, "rotary_dim": 64,
                            "n_positions": 2048, "layer_norm_epsilon": 1e-05,
                            "tie_word_embeddings": False},
    "Qwen/Qwen-7B": {"model_type": "qwen", "vocab_size": 151936,
                     "hidden_size": 4096, "intermediate_size": 22016,
                     "num_hidden_layers": 32, "num_attention_heads": 32,
                     "kv_channels": 128, "seq_length": 8192,
                     "layer_norm_epsilon": 1e-06, "rotary_emb_base": 10000,
                     "tie_word_embeddings": False},
    "baichuan-inc/Baichuan2-7B-Base": {
        "model_type": "baichuan", "vocab_size": 125696, "hidden_size": 4096,
        "intermediate_size": 11008, "num_hidden_layers": 32,
        "num_attention_heads": 32, "model_max_length": 4096,
        "rms_norm_eps": 1e-06, "tie_word_embeddings": False},
}
FAMILY_LAYERS = 2
# phase 19: Llama-2-7B widths quantized on the card (depth the only cut)
# from QUANT_ROWS x QUANT_SEQ synthetic calibration tokens (16384 Hessian
# rows, more than the widest input, 11008)
QUANT_LAYERS = 2
QUANT_ROWS, QUANT_SEQ = 32, 512


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def phase_build():
    from quip_for_all_tpu_torch.ops import _build
    t = time.time()
    sources = sorted({os.path.basename(k["source"])[:-3] for k in KERNELS})
    reports = _build.build_all(sources)
    dt = time.time() - t
    for name in sources:
        _build.load(name)
    for name, rep in reports.items():
        fn = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
    log(f"build: {len(KERNELS)} kernels from {len(sources)} source(s) in "
        f"{dt:.1f} s "
        f"({'built' if reports else 'already built'})")
    log_int_to_float(sources)
    return dt


def log_int_to_float(sources):
    """Count the int->float convert instructions in each built library's
    SASS (I2F, and Hopper's I2FP), where the toolkit has cuobjdump:
    bfp_decode_matmul (K10) exists to decode without them."""
    import re
    from quip_for_all_tpu_torch.ops import _build
    cu = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "cuobjdump")
    if not os.path.isfile(cu):
        log("sass: cuobjdump not found; converts not counted")
        return
    for name in sources:
        r = subprocess.run([cu, "-sass", _build._target(name)],
                           capture_output=True, text=True, timeout=120)
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
            r.stdout)]
        log(f"sass {name}: {ops.count('I2F')} I2F and {ops.count('I2FP')} "
            f"I2FP of {len(ops)} instructions (all kernel instantiations)")


def phase_kernels():
    """fused_decode_matmul (K1) vs its plain twin at the main paths' shapes:
    m = 1, 8, 16 and 32 with one plane set and m = 1 and 32 with two."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, max_err = k1_rows(SHAPES, gen)
    for m, n_sets in [(m, 1) for m in SHAPES[0][4]] + [
            (m, 2) for m in K1_2SETS_M]:
        per = {key: call_sum(rows, LLAMA_CALLS, key, m=m, sets=n_sets)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        log(f"kernel fused_decode_matmul K1 per Llama-2-7B "
            f"{'token' if m <= 8 else 'prefill'} at m={m} ({n_sets} "
            f"set(s), bf16, 129 calls): " + ", ".join(
                f"{k} {v:.3f}" for k, v in per.items()))
    return rows, max_err


def k1_rows(shapes, gen, two_sets=K1_2SETS_M):
    """K1 against its plain twin at each (name, q_out, q_in, scale vector,
    rows m) of ``shapes``, one plane set at every m and two at the m in
    ``two_sets``: the max error, and a timed row per case (kernel, twin,
    library product, bound)."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor
    from quip_for_all_tpu_torch.utils.random_quantized import \
        random_e8p_planes
    rows, max_err = [], 0.0
    for name, q_out, q_in, with_scale, ms in shapes:
        G = q_in // 8
        w = [random_e8p_planes(q_out, q_in, gen, "cuda") for _ in range(2)]
        Gp = w[0].shape[1]
        cps = {n: tm.cold_copies(w[:n]) for n in (1, 2)}
        scale = (torch.rand(q_out, generator=gen, device="cuda") + 0.5
                 if with_scale else None)
        # the library yardstick: one dense bf16 product of the same shape
        # (two plane sets decode to one dense W as well)
        W = decode_weights(QuantizedTensor({"w0": w[0]}, "E8P12", q_out,
                                           q_in), dtype=torch.bfloat16)
        Ws = tm.cold_copies([W])
        cases = [(m, 1) for m in ms] + [(m, 2) for m in ms if m in two_sets]
        for m, n_sets in cases:
            affine = K1_AFFINE[:n_sets]
            cp = cps[n_sets]
            # as the main path gives it: x padded to a multiple of 8 rows,
            # the kernel computing the m real ones
            mp = max(8, -(-m // 8) * 8)
            x = torch.zeros((mp, 8, Gp), device="cuda")
            x[:m, :, :G] = torch.randn((m, 8, G), generator=gen,
                                       device="cuda")
            x = x.reshape(mp, 8 * Gp).to(torch.bfloat16)
            got = fm.fused_decode_matmul(x, cp[0], affine, scale, rows=m)
            want = fm.fused_decode_matmul_ref(x[:m], cp[0], affine, scale)
            torch.cuda.synchronize()
            ok, err = tm.compare(got, want, bf16_step=True)[:2]
            max_err = max(max_err, err)
            if not ok:
                raise AssertionError(
                    f"{name} m={m} {n_sets} set(s): kernel vs plain twin "
                    f"beyond tolerance (max |diff| {err})")
            x_nat = x[:m].reshape(m, 8, Gp)[:, :, :G].transpose(
                1, 2).reshape(m, q_in).contiguous()
            k_ms = 1e-3 * tm.graph_us(lambda i: fm.fused_decode_matmul(
                x, cp[i % len(cp)], affine, scale, rows=m), 4 * len(cp))
            p_ms = 1e-3 * tm.event_us(lambda i: fm.fused_decode_matmul_ref(
                x[:m], cp[i % len(cp)], affine, scale), 3)
            lib_ms = 1e-3 * tm.graph_us(lambda i: torch.matmul(
                x_nat, Ws[i % len(Ws)][0].T), 4 * len(Ws))
            nbytes = n_sets * w[0].numel() * 4 + m * 8 * Gp * 2 + \
                m * q_out * 2 + (q_out * 4 if with_scale else 0)
            ops = 2 * m * q_out * 8 * Gp
            b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
            b_ops = ops / tm.BF16_OPS_PER_S * 1e3
            row = {"layer": name, "q_out": q_out, "Gp": Gp, "m": m,
                   "sets": n_sets, "max_abs_err": err, "ms": k_ms,
                   "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                   "bytes": nbytes}
            rows.append(row)
            log(f"kernel {name:6s} {q_out}x{Gp} m={m:2d} {n_sets} set(s): "
                f"max|k-plain| {err:.3g} (tol 1 bf16 ulp + 1e-5 max) | "
                f"kernel {k_ms * 1e3:.1f} us | plain {p_ms * 1e3:.1f} us | "
                f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}) | "
                f"{k_ms and row['bound_ms'] / k_ms:.0%} of bound | library "
                f"{lib_ms * 1e3:.1f} us (dense bf16 product of the same "
                f"shape, 4x the plane bytes a set)")
        del cps, Ws, W, w
        torch.cuda.empty_cache()
    return rows, max_err


def top2_ids(tokens: int, gen):
    """Expert ids as top-2 routing gives them: 2 distinct experts per
    token, token-major."""
    import torch
    return torch.stack([torch.randperm(MOE_E, generator=gen, device="cuda")
                        [:MOE_K] for _ in range(tokens)]).reshape(-1).to(
        torch.int32)


def phase_moe_kernels():
    """moe_decode_matmul vs its plain twin at Mixtral-8x7B's expert shapes,
    with the rows the main path gives it: R = 2 at bs=1 decode, 16 and 62
    in the sparse prefill of 8 and 31 tokens (experts repeat across
    tokens). The bound counts the planes of the distinct experts once."""
    import torch
    from quip_for_all_tpu_torch.ops import moe_matmul as mm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor
    from quip_for_all_tpu_torch.utils.random_quantized import \
        random_e8p_planes
    gen = torch.Generator(device="cuda").manual_seed(2)
    affine = ((0.5, -2.75),)
    rows, max_err = [], 0.0
    for name, q_out, q_in in MOE_SHAPES:
        G = q_in // 8
        planes = torch.stack([random_e8p_planes(q_out, q_in, gen, "cuda")
                              for _ in range(MOE_E)])
        Gp = planes.shape[2]
        expert_bytes = q_out * Gp * 4
        # every call reads at least 2 experts' planes; alternate copies so
        # each call finds its planes evicted from the 50 MB L2
        copies = max(2, math.ceil(2 * tm.L2_BYTES / (MOE_K * expert_bytes)))
        ps = [planes] + [planes.clone() for _ in range(copies - 1)]
        for R in MOE_R:
            m = R // MOE_K                            # tokens
            eids = top2_ids(m, gen)
            distinct = sorted(set(eids.tolist()))     # host read, untimed
            x = torch.zeros((R, 8, Gp), device="cuda")
            x[:, :, :G] = torch.randn((R, 8, G), generator=gen,
                                      device="cuda")
            x = x.reshape(R, 8 * Gp).to(torch.bfloat16)
            # the main path's bound: an expert has at most m rows
            got = mm.moe_fused_matmul(x, eids, [planes], affine, m)
            want = mm.moe_fused_matmul_ref(x, eids, [planes], affine)
            torch.cuda.synchronize()
            ok, err = tm.compare(got, want, bf16_step=True)[:2]
            max_err = max(max_err, err)
            if not ok:
                raise AssertionError(
                    f"moe {name} R={R}: kernel vs plain twin beyond "
                    f"tolerance (max |diff| {err})")

            # untimed: f32 x at R = 2, two plane sets at R = 16
            if R in MOE_CHECK:
                dt, n_sets = MOE_CHECK[R]
                xc = x
                if dt == "float32":
                    xc = torch.zeros((R, 8, Gp), device="cuda")
                    xc[:, :, :G] = torch.randn((R, 8, G), generator=gen,
                                               device="cuda")
                    xc = xc.reshape(R, 8 * Gp)
                ws = [planes] + [planes.roll(1, 0).contiguous()] * (
                    n_sets - 1)
                got = mm.moe_fused_matmul(xc, eids, ws, K1_AFFINE[:n_sets],
                                          m)
                want = mm.moe_fused_matmul_ref(xc, eids, ws,
                                               K1_AFFINE[:n_sets])
                torch.cuda.synchronize()
                ok, e2 = tm.compare(got, want, bf16_step=True)[:2]
                max_err = max(max_err, e2)
                log(f"kernel moe {name:3s} R={R:2d} {dt}, {n_sets} set(s): "
                    f"max|k-plain| {e2:.3g} (tol 1 bf16 ulp + 1e-5 max)")
                if not ok:
                    raise AssertionError(
                        f"moe {name} R={R} {dt} {n_sets} set(s): kernel vs "
                        f"plain twin beyond tolerance (max |diff| {e2})")
                del ws
            k_ms = 1e-3 * tm.graph_us(lambda i: mm.moe_fused_matmul(
                x, eids, [ps[i % copies]], affine, m), 4 * copies)
            p_ms = 1e-3 * tm.event_us(lambda i: mm.moe_fused_matmul_ref(
                x, eids, [ps[i % copies]], affine), 3)
            # yardstick: one dense bf16 product per distinct expert on its
            # weights decoded beforehand (4x the bytes; not the same
            # function, never called by the port)
            x_nat = x.reshape(R, 8, Gp)[:, :, :G].transpose(1, 2).reshape(
                R, q_in)
            sel = {e: (eids == e).nonzero(as_tuple=True)[0] for e in distinct}
            xs = {e: x_nat[sel[e]].contiguous() for e in distinct}
            Ws = {e: decode_weights(QuantizedTensor(
                {"w0": planes[e]}, "E8P12", q_out, q_in),
                dtype=torch.bfloat16) for e in distinct}
            lib_ms = 1e-3 * tm.graph_us(
                lambda i: [torch.matmul(xs[e], Ws[e].T) for e in distinct], 4)
            del Ws
            nbytes = (len(distinct) * expert_bytes + R * 8 * Gp * 2
                      + R * q_out * 2 + R * 4)
            ops = 2 * R * q_out * q_in
            b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
            b_ops = ops / tm.BF16_OPS_PER_S * 1e3
            row = {"layer": name, "q_out": q_out, "Gp": Gp, "R": R,
                   "experts": len(distinct), "max_abs_err": err,
                   "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                   "bytes": nbytes}
            rows.append(row)
            log(f"kernel moe {name:3s} {q_out}x{Gp} E={MOE_E} R={R:2d} "
                f"({len(distinct)} experts): max|k-plain| {err:.3g} (tol 1 "
                f"bf16 ulp + 1e-5 max) | kernel {k_ms * 1e3:.1f} us | plain "
                f"{p_ms * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.1f} us "
                f"({row['bound_by']}) | {row['bound_ms'] / k_ms:.0%} of "
                f"bound | library {lib_ms * 1e3:.1f} us (dense bf16 matmul "
                f"per expert, 4x the bytes, not the same function)")
        del ps, planes
        torch.cuda.empty_cache()
    return rows, max_err


def phase_golden(cases=(("e8p12", None),)):
    """Golden reference-schema fixtures, loaded by the port in a runtime
    layout and run on the card through the layout's kernel in f32: rel <
    2e-4 as the JAX test holds, and a launch of the expected kernel. A case
    (fixture, layout, True) runs with the right epilogue on."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.models.llama import set_right_in_kernel
    from quip_for_all_tpu_torch.utils.checkpoint import load_quantized
    for fixture, layout, *right in cases:
        path = os.path.join(REPO, "tests", "golden", fixture)
        cfg, model, _ = load_quantized(path, device="cuda", layout=layout)
        set_right_in_kernel(model, bool(right and right[0]))
        if right and right[0]:
            layout = f"{layout or 'nibble'}, right epilogue"
        exp = np.load(os.path.join(path, "expected.npz"))
        blk = model.layers[0]
        for role, lin in (("q_proj", blk["self_attn"]["q_proj"]),
                          ("down_proj", blk["mlp"]["down_proj"])):
            n = lin.in_features
            # the nibble layout's n rows: K1 up to 32, K2 above
            kernel = LAYOUT_KERNEL.get(layout, "fused_decode_matmul" if n <= 32
                                       else "fused_decode_matmul_tc")
            if right and right[0]:
                kernel = "fused_decode_matmul_tc"
            reset_launches()
            got = lin(torch.eye(n, device="cuda"),
                      compute_dtype=torch.float32).cpu().numpy()
            launched = read_launches()[kernel]
            rel = float(np.abs(got - exp[role]).max()
                        / (np.abs(exp[role]).max() + 1e-9))
            log(f"golden {fixture} [{layout or 'nibble'}] {role}: rel err "
                f"{rel:.3g} (tol 2e-4), {launched} {kernel} launch(es)")
            if not (rel < 2e-4 and launched == 1):
                raise AssertionError(f"golden {fixture} {layout} {role}: "
                                     f"rel {rel}, {launched} launches")


def timed_generate(cfg, model, prompt, cache_len, graphs=None):
    """generate(prompt, n) timed on the host clock, synchronised: the
    port's loop (CUDA-graph replays; ``graphs=False`` the same step body
    run eagerly). ``run.runner`` is the last call's ``StepRunner``."""
    import torch
    from quip_for_all_tpu_torch.runtime import generate as G

    def run(n, p=prompt, **kw):
        kw.setdefault("dtype", torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, logits, run.runner = G._generate(
            cfg, model, p, n, cache_len=cache_len, return_logits=True,
            graphs=graphs, **kw)
        torch.cuda.synchronize()
        return (out, logits), time.perf_counter() - t0
    return run


def forwards(runner) -> int:
    """Forward passes of one generate call: its prefill, the warm-up step
    before each capture, and the decode steps replayed or run eagerly
    (each replay launches what its capture recorded)."""
    return 1 + runner.warmups + runner.replays + runner.eager_steps


def graph_note(runner) -> str:
    return (f"{runner.captures} graph(s) captured after as many warm-up "
            f"steps, {runner.replays} replays, {runner.eager_steps} eager "
            "steps")


def _counters():
    """Each kernel's wrapper, which counts its launches: the model's
    decode kernels (``runtime/graphs.py``) and the microbenchmarks'."""
    from quip_for_all_tpu_torch.runtime.graphs import kernel_wrappers
    from quip_for_all_tpu_torch.tools import microbench_bfp as tb
    from quip_for_all_tpu_torch.tools import microbench_decode as td
    from quip_for_all_tpu_torch.tools import microbench_kernel as tk
    from quip_for_all_tpu_torch.tools import microbench_tn as tt
    return {**kernel_wrappers(),
            **{f"mb_kernel:{v}": f for v, f in tk.WRAPPERS.items()},
            **{f"mb_decode:{v}": f for v, f in td.WRAPPERS.items()},
            **{f"mb_tn:{v}": f for v, f in tt.WRAPPERS.items()},
            "mb_bfp_probe": tb.bitcast_probe}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in _counters().items()}


def check_launches(tag, got, expect):
    """Every kernel's count must equal ``expect`` (0 where not named)."""
    expect = {k: expect.get(k, 0) for k in got}
    log(f"{tag}: launches " + ", ".join(
        f"{k} {got[k]} (expected {expect[k]})" for k in expect))
    if got != expect:
        raise AssertionError(f"{tag}: launch counts {got} != {expect}")


def check_runs(tag, cfg, ids1, ids2, logits1, new):
    import torch
    if not torch.equal(ids1, ids2):
        raise AssertionError(f"{tag}: two greedy runs gave different ids")
    lg = torch.stack(logits1)
    if lg.shape != (new, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError(f"{tag}: logits {tuple(lg.shape)} not "
                             "finite/shaped")
    log(f"{tag}: two runs identical ids; logits finite, shape "
        f"{tuple(lg.shape)}")


def phase_main():
    """The Llama-2-7B path; returns its kernel launches."""
    import torch
    import quip_for_all_tpu_torch as qt
    cfg = qt.llama2_7b_config()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    model = qt.fuse_for_inference(cfg, model)
    torch.cuda.synchronize()
    log(f"main: built Llama-2-7B E8P12 (random codes, seed 0, fused, "
        f"quantized head) in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, NEW, CACHE = 32, 128, 2048
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    run = timed_generate(cfg, model, prompt, CACHE)
    run(4)                                           # warm-up
    (_, _), t_pre = run(1)                           # prefill only
    reset_launches()
    (ids1, logits1), t1 = run(NEW)
    launches = read_launches()
    fwd = forwards(run.runner)
    note = graph_note(run.runner)
    (ids2, _), t2 = run(NEW)
    per_step = 4 * LAYERS + 1
    ms_tok = (t1 - t_pre) / (NEW - 1) * 1e3
    ms_tok2 = (t2 - t_pre) / (NEW - 1) * 1e3
    log(f"main: prompt {S} + {NEW} greedy tokens, cache_len {CACHE}: "
        f"prefill {t_pre * 1e3:.1f} ms, decode {ms_tok:.2f} ms/token "
        f"({1e3 / ms_tok:.1f} tok/s); second run {ms_tok2:.2f} ms/token; "
        f"{note}")
    # prefill, warm-up and (NEW - 1) decode steps, per_step launches each
    check_launches("main", launches, {"fused_decode_matmul":
                                      per_step * fwd,
                                      "moe_decode_matmul": 0})
    check_runs("main", cfg, ids1, ids2, logits1, NEW)

    # every linear on the plain twin, same path otherwise: in bf16 (the
    # main path; bf16 rounding of every linear output amplifies through 32
    # random layers, hence 5e-2) and in f32 (sum order only, 1e-3)
    for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        check_plain(cfg, model, prompt, dt, tol, CACHE,
                    per_step={"fused_decode_matmul": 4 * LAYERS + 1})
    dev_ms, eager_ms = decode_step_device_ms(cfg, model, prompt, CACHE)
    log(f"main: one decode step (position {S}): device time {dev_ms:.2f} ms "
        f"(CUDA-graph replay), eager {eager_ms:.2f} ms -> device idle "
        f"{1 - dev_ms / eager_ms:.0%} of the eager step")
    pre_ms, pre_eager = prefill_device_ms(cfg, model, prompt, CACHE)
    log(f"main: the {S}-token prefill (K1 at m = {S}): device time "
        f"{pre_ms:.2f} ms (CUDA-graph replay), eager {pre_eager:.2f} ms -> "
        f"device idle {1 - pre_ms / pre_eager:.0%} of the eager prefill")
    # the f32 logits that the re-laid paths (d)-(f) are held to
    _, ref = f32_logits(cfg, model, prompt)
    return launches["fused_decode_matmul"], {
        "cfg": cfg, "model": model, "prompt": prompt, "ref": ref,
        "dev_ms": dev_ms, "eager_ms": eager_ms}


def phase_graphed(main):
    """(a) ``generate`` on the main path's model (``main``, phase 5's):
    the graphed loop timed on the host clock over the whole call beside
    the eager step loop, the two bitwise equal, a run across the 256
    bucket boundary, ``generate_stream``, the int8 KV cache, and the exact
    K1 launches of each run."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.runtime import generate as G
    cfg, model, prompt = main["cfg"], main["model"], main["prompt"]
    S, NEW, CACHE = prompt.shape[1], 128, 2048
    per_step = 4 * LAYERS + 1
    graphed = timed_generate(cfg, model, prompt, CACHE)
    eager = timed_generate(cfg, model, prompt, CACHE, graphs=False)
    runs = {}
    for tag, run in (("graphed", graphed), ("eager", eager)):
        reset_launches()
        (ids, logits), t = run(NEW)
        check_launches(f"a {tag}", read_launches(), {
            "fused_decode_matmul": per_step * forwards(run.runner)})
        runs[tag] = (ids, torch.stack(logits), t, run.runner)
        if tag == "graphed":
            k1 = read_launches()["fused_decode_matmul"]
    (ids_g, lg_g, t_g, r_g), (ids_e, lg_e, t_e, _) = (runs["graphed"],
                                                       runs["eager"])
    same = torch.equal(ids_g, ids_e) and torch.equal(lg_g, lg_e)
    out = {"ms_tok": t_g / NEW * 1e3, "eager_ms_tok": t_e / NEW * 1e3,
           "k1_launches": k1,
           "dev_ms": main["dev_ms"], "eager_step_ms": main["eager_ms"]}
    log(f"a: generate, prompt {S} + {NEW} greedy tokens, cache_len {CACHE}"
        f", host clock over the whole call: graphed {out['ms_tok']:.2f} "
        f"ms/token ({1e3 / out['ms_tok']:.1f} tok/s; {graph_note(r_g)}), "
        f"eager step loop {out['eager_ms_tok']:.2f} ms/token; one graphed "
        f"step's device time {main['dev_ms']:.2f} ms, one eager step "
        f"{main['eager_ms']:.2f} ms (phase 5); graphed ids and logits "
        f"bitwise equal to the eager loop's: {same}")
    if not same:
        raise AssertionError("a: graphed loop differs from the eager loop")

    # across the 256 bucket boundary: two graphs
    gen = torch.Generator(device="cuda").manual_seed(1)
    long = torch.randint(0, cfg.vocab_size, (1, 240), generator=gen,
                         device="cuda")
    reset_launches()
    (ids_c, lg_c), t_c = graphed(32, p=long)
    r_c = graphed.runner
    # the 240-token prefill runs K2 (above 32 rows), each step K1
    check_launches("a across 256", read_launches(), {
        "fused_decode_matmul": per_step * (forwards(r_c) - 1),
        "fused_decode_matmul_tc": per_step})
    (ids_ce, lg_ce), _ = eager(32, p=long)
    same = (torch.equal(ids_c, ids_ce)
            and torch.equal(torch.stack(lg_c), torch.stack(lg_ce)))
    log(f"a: prompt 240 + 32 tokens (buckets {sorted(r_c.graphs)}): "
        f"{graph_note(r_c)}; {t_c / 32 * 1e3:.2f} ms/token over the call; "
        f"bitwise equal to the eager loop: {same}")
    if sorted(r_c.graphs) != [256, 512] or not same:
        raise AssertionError("a: the run across 256 did not take two "
                             "graphs or differs from the eager loop")

    # generate_stream, chunks of 8: the JAX chunk sizes, the same ids
    buckets = len({w for _, w in G._segments(S, NEW - 1, CACHE, 8)})
    reset_launches()
    t = time.perf_counter()
    chunks = list(G.generate_stream(cfg, model, prompt, NEW, chunk=8,
                                    cache_len=CACHE, dtype=torch.bfloat16))
    t = time.perf_counter() - t
    check_launches("a stream", read_launches(), {
        "fused_decode_matmul": per_step * (NEW + buckets)})
    sizes = [c.shape[1] for c in chunks]
    got = np.concatenate(chunks, axis=1)[0]
    same = bool(np.array_equal(got, ids_g[0, S:].cpu().numpy()))
    log(f"a: generate_stream chunk 8: {len(chunks)} chunks, sizes "
        f"{sizes[:3]}...{sizes[-2:]}, {t / NEW * 1e3:.2f} ms/token; ids "
        f"equal generate's: {same}")
    if not same or sizes != [1] + [8] * ((NEW - 1) // 8) + (
            [(NEW - 1) % 8] if (NEW - 1) % 8 else []):
        raise AssertionError("a: generate_stream differs from generate")

    # the int8 KV cache: its first 8 steps against the bf16 cache's
    reset_launches()
    (ids_q, lg_q), t_q = graphed(NEW, kv_quantized=True)
    check_launches("a int8 cache", read_launches(), {
        "fused_decode_matmul": per_step * forwards(graphed.runner)})
    lg_q = torch.stack(lg_q)
    k_q, k_b = ids_q[0, S:S + 8], ids_g[0, S:S + 8]
    same = int((k_q == k_b).long().cumprod(0).sum())
    n_cmp = min(8, same + 1)          # steps fed the same tokens
    rel = float(((lg_q[:n_cmp] - lg_g[:n_cmp]).abs().max()
                 / lg_g[:n_cmp].abs().max()))
    gap = 0.0
    if same < 8:
        row = lg_g[same][0]
        gap = float((row.max() - row[k_q[same]]) / row.abs().max())
    # all 8 steps on the same tokens: the bf16 run's prompt and first 7
    # tokens in one forward through an int8 cache, against its 8 steps
    from quip_for_all_tpu_torch.models import llama as M
    caches = G.init_kv_caches(cfg, 1, CACHE, torch.bfloat16, "cuda",
                              quantized=True)
    lf, _ = M.model_apply(cfg, model, ids_g[:, :S + 7], kv_caches=caches,
                          cache_position=0, dtype=torch.bfloat16,
                          attn_window=G.attn_bucket(S + 7, CACHE))
    lf = lf[0, S - 1:].float()
    rel8 = float((lf - lg_g[:8, 0]).abs().max() / lg_g[:8].abs().max())
    log(f"a: int8 KV cache, one forward over the bf16 run's prompt and "
        f"first 7 tokens: logits of its 8 steps within {rel8:.3g} of "
        f"max|logit| of the bf16 cache run's (tol {INT8_TOL})")
    if not rel8 <= INT8_TOL:
        raise AssertionError("a: int8 cache logits beyond tolerance")
    out.update(int8_ms_tok=t_q / NEW * 1e3, int8_rel=rel,
               int8_rel_8_steps=rel8)
    log(f"a: int8 KV cache, {NEW} tokens: {out['int8_ms_tok']:.2f} "
        f"ms/token over the call; logits of the first {n_cmp} steps fed the"
        f" same tokens within {rel:.3g} of max|logit| of the bf16 cache's "
        f"(tol {INT8_TOL}); greedy tokens equal for {same}/8 steps" + (
            f"; at step {same} the int8 run's token is {gap:.3g} of "
            f"max|logit| below the bf16 argmax (tol {INT8_TOL})"
            if same < 8 else ""))
    if not (rel <= INT8_TOL and gap <= INT8_TOL):
        raise AssertionError("a: int8 cache logits beyond tolerance")
    return out


def serving_requests(cfg, n, seed, prompt_len, new_tokens):
    """n requests from ``seed``: prompt lengths and max_new_tokens drawn
    uniformly in the given (low, high) ranges, token ids uniform."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_len[0], prompt_len[1] + 1, n)
    news = rng.integers(new_tokens[0], new_tokens[1] + 1, n)
    return [(rng.integers(0, cfg.vocab_size, int(L)), int(m))
            for L, m in zip(lens, news)]


def serve(tag, cfg, model, requests, eng=None, **kw):
    """``requests`` through a ``ServingEngine`` on the host clock: a new
    one built from ``kw`` (cold: its captures and their warm-up steps
    count in the run), or ``eng`` warm from an earlier run (graphs already
    captured). Requests, tokens, wall seconds, aggregate tok/s, time to
    first token, each request's time per output token after its first
    ((last - first) / (n - 1) of its ``on_token`` stamps: tokens arrive
    in fetched bursts, so the gap between two callbacks is not what a
    user waits), the run's forwards by kind and the kernels' launches."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.runtime.serving import ServingEngine
    stamps = {}

    def on_token(rid, tok, done):
        stamps.setdefault(rid, []).append(time.perf_counter())
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = eng is not None
    if warm:
        eng.on_token = on_token
    else:
        eng = ServingEngine(cfg, model, on_token=on_token, **kw)
    r = eng.runner
    graphs0, runs0 = set(r.graphs), dict(r.runs_by_key)
    chunks0, steps0 = eng.prefill_chunks, eng.decode_steps
    rids = [eng.add_request(p, m) for p, m in requests]
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    new = set(r.graphs) - graphs0          # captured in this run
    toks = sum(len(stamps[q]) for q in rids)
    ttft = np.array([stamps[q][0] - t0 for q in rids]) * 1e3
    tpot = np.array([(stamps[q][-1] - stamps[q][0]) / (len(stamps[q]) - 1)
                     for q in rids if len(stamps[q]) > 1]) * 1e3
    st = {"requests": len(rids), "tokens": toks, "wall_s": wall,
          "warm": warm, "tok_s": toks / wall,
          "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "ttft_ms_p99": float(np.percentile(ttft, 99)),
          "tpot_ms_p50": float(np.percentile(tpot, 50)),
          "tpot_ms_p99": float(np.percentile(tpot, 99)),
          "prefill_chunks": eng.prefill_chunks - chunks0,
          "decode_steps": eng.decode_steps - steps0,
          "prefill_fwd": eng.prefill_chunks - chunks0 + sum(
              1 for k in new if k[0] == "prefill"),
          "decode_fwd": eng.decode_steps - steps0 + sum(
              1 for k in new if k[0] == "decode"),
          "captures": len(new),
          "runs": {f"{k[0]} {k[1]}": n - runs0.get(k, 0)
                   for k, n in r.runs_by_key.items()},
          "graphs": sorted(r.graphs), "launches": launches}
    how = ("warm engine, nothing captured" if warm else
           "cold engine, its captures and warm-up steps included")
    log(f"{tag}: {st['requests']} requests, {toks} tokens in {wall:.2f} s "
        f"wall ({how}): {st['tok_s']:.1f} tok/s; time to first token p50 "
        f"{st['ttft_ms_p50']:.0f} ms, p99 {st['ttft_ms_p99']:.0f} ms; time "
        f"per output token after the first, per request, p50 "
        f"{st['tpot_ms_p50']:.2f} ms, p99 {st['tpot_ms_p99']:.2f} ms; "
        f"{st['prefill_chunks']} prefill chunks, {st['decode_steps']} "
        f"decode steps; {len(new)} graph(s) captured, graphs "
        f"{st['graphs']}")
    if warm and new:
        raise AssertionError(f"{tag}: the warm engine captured {new}")
    for rid, (p, m) in zip(rids, requests):
        if res[rid].shape[0] != p.shape[0] + m:
            raise AssertionError(f"{tag}: request {rid} returned "
                                 f"{res[rid].shape[0]} ids")
    return [res[rid] for rid in rids], st, eng


def graph_device_ms(eng, reps=5):
    """Device ms of one replay of each of the engine's graphs (CUDA events
    around each replay, the mean of ``reps`` after a warm one), by key.
    The engine has finished: a replay rewrites only its scratch state
    (the step index is put back to 0 before each, as a chunk starts);
    launch counts are not touched."""
    import torch
    out = {}
    for key, (graph, _) in sorted(eng.runner.graphs.items()):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        eng._j.zero_()
        graph.replay()
        for t0, t1 in ev:
            eng._j.zero_()
            t0.record()
            graph.replay()
            t1.record()
        torch.cuda.synchronize()
        out[key] = sum(t0.elapsed_time(t1) for t0, t1 in ev) / reps
    return out


def log_serving_device(tag, eng, runs):
    """An estimate of each serving run's device busy share, not a trace:
    each graph's replay is timed once the engine has finished, and a run's
    prefill chunks and decode steps are reckoned at those times against
    its wall time. ``runs`` are ``serve``'s stats of the engine's runs."""
    ms = {f"{k[0]} {k[1]}": v for k, v in graph_device_ms(eng).items()}
    log(f"{tag}: one replay's device time: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(ms.items())))
    for st in runs:
        busy = sum(ms[k] * n for k, n in st["runs"].items()) / 1e3
        st.update(graph_ms=ms, device_busy_s_estimate=busy)
        log(f"{tag} ({'warm' if st['warm'] else 'cold'}): estimated device "
            f"busy {busy:.2f} s of {st['wall_s']:.2f} s wall "
            f"({busy / st['wall_s']:.0%}; replays timed after the run, "
            "not traced)")


def check_serving_launches(tag, st, per_prefill, per_decode):
    """Exact launches of a serving run: each kernel's count a forward of
    each kind, times the run's forwards of that kind."""
    check_launches(tag, st["launches"], {
        k: per_prefill.get(k, 0) * st["prefill_fwd"]
        + per_decode.get(k, 0) * st["decode_fwd"]
        for k in set(per_prefill) | set(per_decode)})


def check_traced(tag, slug, fn, runner_of):
    """Run ``fn`` under ``torch.profiler`` (``tools/_timing.py``
    ``traced_launches``): the kernels the trace sees ran on the card must
    equal the wrappers' counts of the same run, which reckon every
    CUDA-graph replay from its capture. ``runner_of()`` is the run's
    ``StepRunner``, which must have replayed."""
    from quip_for_all_tpu_torch.tools._timing import traced_launches
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    reset_launches()
    seen = traced_launches(fn, os.path.join(REPO, "build",
                                            f"trace_{slug}.json"))
    got = read_launches()
    counted = {k: got[k] for k in seen}
    runner = runner_of()
    log(f"{tag}: kernels the profiler trace saw {seen}; the wrappers' "
        f"counts {counted}; {graph_note(runner)}")
    if seen != counted or runner.replays == 0 or not any(seen.values()):
        raise AssertionError(f"{tag}: the trace saw {seen}, the wrappers "
                             f"counted {counted}")
    return seen


def phase_serving(main):
    """(b) ``ServingEngine`` on the main path's model: 16 requests at 8
    slots in bf16 on a cold engine, then the same requests again on the
    warm engine, each with exact K1 / K2 launches; then 4 requests at 4
    slots in f32, each request's ids held to f32 ``generate`` of its
    prompt alone."""
    import gc
    import numpy as np
    import torch
    import quip_for_all_tpu_torch as qt
    cfg, model = main["cfg"], main["model"]
    per_fwd = 4 * LAYERS + 1
    # prefill chunks of 8 x 128 = 1024 rows run K2, decode steps of 8
    # rows K1; each forward runs every quantized linear once
    counts = ({"fused_decode_matmul_tc": per_fwd},
              {"fused_decode_matmul": per_fwd})
    reqs = serving_requests(cfg, SERVE_N, 0, SERVE_PROMPT, SERVE_NEW)
    _, st, eng = serve("b serving", cfg, model, reqs, max_batch=8,
                       cache_len=2048, prefill_chunk=128, decode_chunk=8,
                       dtype=torch.bfloat16)
    check_serving_launches("b serving", st, *counts)
    _, warm, _ = serve("b serving", cfg, model, reqs, eng=eng)
    check_serving_launches("b serving (warm)", warm, *counts)
    log_serving_device("b serving", eng, (st, warm))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    f32 = {"compute_dtype": torch.float32}
    small = [(p, 16) for p, _ in reqs[:4]]
    outs, st32, _ = serve("b serving f32", cfg, model, small, max_batch=4,
                          cache_len=2048, prefill_chunk=128, decode_chunk=8,
                          dtype=torch.float32, linear_kw=f32)
    check_serving_launches("b serving f32", st32, *counts)
    same = 0
    for (p, m), got in zip(small, outs):
        want = qt.generate(cfg, model, torch.as_tensor(p)[None].cuda(), m,
                           cache_len=2048, dtype=torch.float32,
                           linear_kw=f32)[0].cpu().numpy()
        same += int(np.array_equal(got, want))
    log(f"b serving f32: {same}/4 requests' ids equal f32 generate of the "
        "prompt alone")
    if same != 4:
        raise AssertionError("b: f32 serving differs from f32 generate")
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": st, "bf16_warm": warm, "f32": st32}


def phase_cli():
    """(d) The port's CLIs on the golden checkpoint (tests/golden/e8p12,
    one layer, unfused, head not quantized: 7 K1 or K2 launches a
    forward): generate (8 greedy tokens, two runs as the JAX CLI makes)
    and eval_ppl (synthetic, 4 windows of 64: K2 at 64 rows)."""
    import io
    from quip_for_all_tpu_torch.cli import eval_ppl, generate as cli_gen
    path = os.path.join(REPO, "tests", "golden", "e8p12")
    prompt = "Hello, my name is"
    buf = io.StringIO()
    reset_launches()
    # the golden checkpoint has no tokenizer: the CLI's byte-id fallback,
    # whether or not this machine has ``transformers``
    saved = sys.modules.get("transformers")
    sys.modules["transformers"] = None
    try:
        with contextlib.redirect_stdout(buf):
            cli_gen.main(["--model-path", path, "--prompt", prompt,
                          "--max-new-tokens", "8", "--temperature", "0",
                          "--cache-len", "64", "--device", "cuda"])
    finally:
        if saved is None:
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved
    printed = buf.getvalue().strip().splitlines()
    log("d: cli.generate printed: " + " | ".join(printed))
    ids = json.loads(next(line for line in reversed(printed)
                          if line.startswith("[")))
    # per run: prefill, one warm-up, 7 replays (one bucket)
    check_launches("d cli generate", read_launches(),
                   {"fused_decode_matmul": 7 * 2 * (8 + 1)})
    log(f"d: cli.generate --max-new-tokens 8 --temperature 0 --device "
        f"cuda: {len(ids)} ids")
    if len(ids) != len(prompt.encode()) + 8:
        raise AssertionError("d: cli.generate printed the wrong length")
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        eval_ppl.main(["--model-path", path, "--dataset", "synthetic",
                       "--nsamples", "4", "--seqlen", "64", "--device",
                       "cuda"])
    line = buf.getvalue().strip().splitlines()[-1]
    check_launches("d cli eval_ppl", read_launches(),
                   {"fused_decode_matmul_tc": 7 * 4})
    log(f"d: cli.eval_ppl --dataset synthetic --nsamples 4 --seqlen 64: "
        f"{line}")
    if not math.isfinite(json.loads(line)["ppl"]):
        raise AssertionError("d: eval_ppl gave a non-finite ppl")


@contextlib.contextmanager
def labelled(targets):
    """While active, each (module, name, label) function runs inside a
    ``torch.profiler.record_function(label)`` range."""
    from torch.profiler import record_function
    saved = []
    for mod, name, label in targets:
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)
        setattr(mod, name, wrap)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def kernel_breakdown(trace):
    """Device time of a chrome trace's kernels by name, and by the
    innermost labelled range that launched them (a kernel's launch is
    found by its correlation id)."""
    ev = trace["traceEvents"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in ev if e.get("cat") == "user_annotation"
                     and e.get("ph") == "X"), key=lambda r: r[0])
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if str(e.get("cat", "")).startswith("cuda_")
              and "correlation" in e.get("args", {})}
    by_name, by_label, count, label_n = {}, {}, {}, {}
    for e in ev:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e["name"]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
        count[name] = count.get(name, 0) + 1
        ts = launch.get(e.get("args", {}).get("correlation"))
        label = "unlabelled"
        if ts is not None:
            inner = [r for r in ranges if r[0] <= ts <= r[1]]
            if inner:
                label = min(inner, key=lambda r: r[1] - r[0])[2]
        if "mma_small_kernel" in name:
            label = "K1 (fused_decode_matmul)"
        by_label[label] = by_label.get(label, 0.0) + e["dur"]
        label_n[label] = label_n.get(label, 0) + 1
    return by_name, count, by_label, label_n


def profile_step(tag, cfg, model, tok, pos, caches, window):
    """``torch.profiler`` over one eager decode step (tokens ``tok`` (B, 1)
    at cache position ``pos``: a host int or a (B,) tensor): device time
    by kernel name (top 15), by the model part that launched it, and the
    sum outside K1. The chrome trace goes to build/profile_<tag>.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from quip_for_all_tpu_torch.models import llama as M
    from quip_for_all_tpu_torch.nn import qlinear as Q
    B = tok.shape[0]
    positions = (torch.full((B, 1), pos, device="cuda")
                 if isinstance(pos, int) else pos[:, None])

    def step():
        M.model_apply(cfg, model, tok, positions=positions, kv_caches=caches,
                      cache_position=pos, dtype=torch.bfloat16,
                      attn_window=window)
    targets = [(Q, "apply", "linear: right transform, scales, casts"),
               (Q, "fused_apply", "linear: right transform, scales, casts"),
               (Q, "_grouped_prologue_matmul", "linear: left transform"),
               (Q, "hadamard_transform", "linear: right Hadamard"),
               (Q, "matmul_hadU", "linear: right Hadamard"),
               (Q, "finish_right", "linear: right Hadamard"),
               (M, "sdpa_cache_layout", "attention (scores, softmax, "
                                        "values)"),
               (M, "write_kv", "kv cache write"),
               (M, "apply_rope", "rope"), (M, "rope_tables", "rope"),
               (M, "rms_norm", "rms norm"), (M, "cache_mask", "mask")]
    with labelled(targets):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    path = os.path.join(REPO, "build", f"profile_{tag}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        by_name, count, by_label, label_n = kernel_breakdown(json.load(f))
    total = sum(by_name.values())
    if total <= 0:
        raise AssertionError("e: the profiler saw no device time")
    k1 = by_label.get("K1 (fused_decode_matmul)", 0.0)
    log(f"e {tag}: one eager decode step ({B} row(s), bucket {window}), "
        f"torch.profiler: {sum(count.values())} device ops, "
        f"{total / 1e3:.3f} ms device time; K1 {k1 / 1e3:.3f} ms "
        f"({count_k1(count)} launches); outside K1 "
        f"{(total - k1) / 1e3:.3f} ms")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"e {tag}: kernel {us / 1e3:8.3f} ms  x{count[name]:4d}  "
            f"{name[:110]}")
    for label, us in sorted(by_label.items(), key=lambda kv: -kv[1]):
        log(f"e {tag}: part {us / 1e3:8.3f} ms ({us / total:.1%}) in "
            f"{label_n[label]:4d} device ops  {label}")
    return {"total_ms": total / 1e3, "k1_ms": k1 / 1e3,
            "outside_k1_ms": (total - k1) / 1e3,
            "by_part_ms": {k: v / 1e3 for k, v in by_label.items()},
            "by_part_ops": label_n}


def phase_profile(main):
    """(e) ``torch.profiler`` over one eager decode step of the main path
    (1 row at position 32, bucket 256, after the 32-token prefill), and
    over one decode step shaped as the serving engine's at 8 slots (rows
    at positions 960-967 of a 2048 + 128 cache, bucket 1024, per-row
    cache positions); then the launch counts of a graphed generate and a
    serving run held to the kernels their traces show."""
    import torch
    from quip_for_all_tpu_torch.models import llama as M
    from quip_for_all_tpu_torch.runtime.generate import (attn_bucket,
                                                         init_kv_caches)
    from quip_for_all_tpu_torch.runtime.serving import ServingEngine
    cfg, model, prompt = main["cfg"], main["model"], main["prompt"]
    S, CACHE = prompt.shape[1], 2048
    caches = init_kv_caches(cfg, 1, CACHE, torch.bfloat16, "cuda")
    M.model_apply(cfg, model, prompt, kv_caches=caches, cache_position=0,
                  dtype=torch.bfloat16, attn_window=attn_bucket(S, CACHE))
    out = {"decode_step": profile_step(
        "decode_step", cfg, model, prompt[:, -1:], S, caches,
        attn_bucket(S + 1, CACHE))}
    del caches
    caches = init_kv_caches(cfg, 8, CACHE + 128, torch.bfloat16, "cuda")
    pos = torch.arange(960, 968, device="cuda")
    out["serving_step_8_rows"] = profile_step(
        "serving_step", cfg, model, prompt[:, -1:].repeat(8, 1), pos,
        caches, attn_bucket(968, CACHE))
    del caches
    torch.cuda.empty_cache()

    # the counts under graphs held to a profiler trace: a graphed generate
    # (K1) and a small serving run (prefill chunks of 8 x 128 rows on K2,
    # decode steps on K1)
    graphed = timed_generate(cfg, model, prompt, CACHE)
    check_traced("e traced generate", "generate", lambda: graphed(8),
                 lambda: graphed.runner)
    made = {}

    def serve_small():
        eng = made["eng"] = ServingEngine(
            cfg, model, max_batch=8, cache_len=CACHE, prefill_chunk=128,
            decode_chunk=8, dtype=torch.bfloat16)
        for p, m in serving_requests(cfg, 2, 1, (100, 200), (8, 8)):
            eng.add_request(p, m)
        eng.run()
    seen = check_traced("e traced serving", "serving", serve_small,
                        lambda: made["eng"].runner)
    if not seen["fused_decode_matmul_tc"]:
        raise AssertionError("e: the trace saw no K2 launch")
    del made
    torch.cuda.empty_cache()
    return out


def count_k1(count):
    return sum(n for name, n in count.items() if "mma_small_kernel" in name)


def phase_mixtral():
    """The Mixtral-8x7B path at all 32 layers and full width. Returns its
    launch counts and its step times."""
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.models.config import mixtral_8x7b_config
    from quip_for_all_tpu_torch.runtime.serving import ServingEngine
    cfg = mixtral_8x7b_config()
    L, E = cfg.num_hidden_layers, cfg.num_local_experts
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    model = qt.fuse_for_inference(cfg, model)
    torch.cuda.synchronize()
    log(f"mixtral: built Mixtral-8x7B E8P12 ({L} layers, {E} experts top-"
        f"{cfg.num_experts_per_tok}; random codes, seed 0, experts stacked, "
        f"fused qkv, quantized head) in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card "
        f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, NEW, CACHE = 32, 64, 2048
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    run = timed_generate(cfg, model, prompt, CACHE)
    run(4)                                           # warm-up
    (_, _), t_pre = run(1)                           # prefill only
    reset_launches()
    (ids1, logits1), t1 = run(NEW)
    launches = read_launches()
    steps = forwards(run.runner) - 1
    note = graph_note(run.runner)
    (ids2, _), t2 = run(NEW)
    ms_tok = (t1 - t_pre) / (NEW - 1) * 1e3
    ms_tok2 = (t2 - t_pre) / (NEW - 1) * 1e3
    log(f"mixtral: prompt {S} + {NEW} greedy tokens, cache_len {CACHE}: "
        f"prefill {t_pre * 1e3:.1f} ms, decode {ms_tok:.2f} ms/token "
        f"({1e3 / ms_tok:.1f} tok/s); second run {ms_tok2:.2f} ms/token; "
        f"{note}")
    # the 32-token prefill runs the dense masked expert loop (qkv, o and
    # 3 linears of each expert per layer, and the head through the fused
    # kernel); each decode step (the warm-up's too) the sparse route (qkv,
    # o, head fused; w13 and w2 per layer through the MoE kernel)
    check_launches("mixtral", launches, {
        "fused_decode_matmul": L * (2 + 3 * E) + 1 + steps * (2 * L + 1),
        "moe_decode_matmul": steps * 2 * L})
    check_runs("mixtral", cfg, ids1, ids2, logits1, NEW)

    # a prompt under 32 tokens prefills through the sparse route (R = 32)
    short = prompt[:, :16].contiguous()
    reset_launches()
    (ids_s, logits_s), _ = run(4, p=short)
    fwd = forwards(run.runner)
    check_launches("mixtral (16-token prompt, sparse prefill)",
                   read_launches(),
                   {"fused_decode_matmul": fwd * (2 * L + 1),
                    "moe_decode_matmul": fwd * 2 * L})
    if not torch.isfinite(torch.stack(logits_s)).all():
        raise AssertionError("mixtral: 16-token prompt logits not finite")
    pre_ms = log_prefill("mixtral", cfg, model, short, CACHE,
                         "moe_decode_matmul")

    for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        check_plain(cfg, model, prompt, dt, tol, CACHE, tag="mixtral")
    dev_ms, eager_ms = decode_step_device_ms(cfg, model, prompt, CACHE)
    log(f"mixtral: one decode step (position {S}): device time {dev_ms:.2f}"
        f" ms (CUDA-graph replay), eager {eager_ms:.2f} ms -> device idle "
        f"{1 - dev_ms / eager_ms:.0%} of the eager step")

    # (c) the serving engine: 4 requests at 4 slots, cold then warm; a
    # prefill chunk of 4 x 128 rows takes the dense expert loop (K2), a
    # decode step of 4 rows the sparse route (K1 for qkv, o and the head,
    # K4 for w13, w2)
    counts = ({"fused_decode_matmul_tc": L * (2 + 3 * E) + 1},
              {"fused_decode_matmul": 2 * L + 1, "moe_decode_matmul": 2 * L})
    reqs = serving_requests(cfg, 4, 0, (16, 128), (16, 16))
    _, st, eng = serve("c mixtral serving", cfg, model, reqs, max_batch=4,
                       cache_len=CACHE, prefill_chunk=128, decode_chunk=8,
                       dtype=torch.bfloat16)
    check_serving_launches("c mixtral serving", st, *counts)
    _, warm, _ = serve("c mixtral serving", cfg, model, reqs, eng=eng)
    check_serving_launches("c mixtral serving (warm)", warm, *counts)
    log_serving_device("c mixtral serving", eng, (st, warm))
    del eng
    # the counts under graphs held to a profiler trace: a small serving
    # run (prefill chunks of 4 x 32 rows on the dense expert loop, K2;
    # decode steps on K1 and K4)
    made = {}

    def serve_small():
        eng = made["eng"] = ServingEngine(
            cfg, model, max_batch=4, cache_len=CACHE, prefill_chunk=32,
            decode_chunk=4, dtype=torch.bfloat16)
        for p, m in serving_requests(cfg, 2, 1, (16, 32), (6, 6)):
            eng.add_request(p, m)
        eng.run()
    seen = check_traced("c traced mixtral serving", "mixtral_serving",
                        serve_small, lambda: made["eng"].runner)
    if not seen["moe_decode_matmul"]:
        raise AssertionError("c: the trace saw no K4 launch")
    del made
    return {"launches": launches, "ms_tok": ms_tok, "dev_ms": dev_ms,
            "eager_ms": eager_ms, "sparse_prefill_device_ms": pre_ms,
            "serving": st, "serving_warm": warm}


def widths_rule(model):
    """(K1 launches, dense-route linears) per forward pass as the fused
    route's shape rule predicts them: each quantized linear, fused or not,
    launches K1 at m <= 32 where ``supports`` holds (q_out % 128 == 0 and
    q_in % 8 == 0), and takes the dense decode + matmul elsewhere."""
    from quip_for_all_tpu_torch.nn.qlinear import (FusedQuantLinear,
                                                   QuantLinear)
    from quip_for_all_tpu_torch.ops.fused_matmul import supports
    k1 = dense = 0
    for mod in model.modules():
        if isinstance(mod, (QuantLinear, FusedQuantLinear)) and \
                mod.plane_keys:
            k1 += supports(mod.qweight)
            dense += not supports(mod.qweight)
    return k1, dense


@contextlib.contextmanager
def dense_route_calls():
    """Counts the quantized linears that take the dense route (each decodes
    its weights once) while active; yields a one-element list."""
    from quip_for_all_tpu_torch.ops import quant_matmul as qm
    orig, n = qm.decode_weights, [0]

    def counted(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)
    qm.decode_weights = counted
    try:
        yield n
    finally:
        qm.decode_weights = orig


def family_routes(tag, cfg, model, prompt, cache_len):
    """K1 launches and dense-route linears per forward of two eager
    forwards (the prompt's prefill, one decode step), held to the shape
    rule's prediction; returns (K1, dense) per forward."""
    import torch
    from quip_for_all_tpu_torch.runtime import generate as G
    k1, dense = widths_rule(model)
    reset_launches()
    with dense_route_calls() as n:
        G._generate(cfg, model, prompt, 2, cache_len=cache_len,
                    dtype=torch.bfloat16, graphs=False)
    got = read_launches()["fused_decode_matmul"]
    log(f"{tag}: per forward {got / 2:g} K1 launches and {n[0] / 2:g} "
        f"dense-route linears; the widths rule predicts {k1} and {dense}")
    if (got, n[0]) != (2 * k1, 2 * dense):
        raise AssertionError(f"{tag}: routes ({got}, {n[0]}) over two "
                             f"forwards, predicted ({2 * k1}, {2 * dense})")
    return k1, dense


def graphed_vs_eager(tag, cfg, model, prompt, new, cache_len, k1):
    """Graphed ``generate`` of ``new`` tokens beside the eager step loop:
    ids and logits bitwise equal, exact K1 launches; returns the graphed
    run's launches, host ms/token over the call and its runner."""
    import torch
    out = {}
    for kind, graphs in (("graphed", None), ("eager", False)):
        run = timed_generate(cfg, model, prompt, cache_len, graphs=graphs)
        reset_launches()
        (ids, logits), t = run(new)
        launches = read_launches()
        check_launches(f"{tag} {kind}", launches, {
            "fused_decode_matmul": k1 * forwards(run.runner)})
        out[kind] = (ids, torch.stack(logits), t, run.runner, launches)
    (ids_g, lg_g, t_g, r_g, launches), (ids_e, lg_e, t_e, *_) = (
        out["graphed"], out["eager"])
    same = torch.equal(ids_g, ids_e) and torch.equal(lg_g, lg_e)
    finite = bool(torch.isfinite(lg_g).all())
    log(f"{tag}: generate, prompt {prompt.shape[1]} + {new} greedy tokens, "
        f"cache_len {cache_len}, host clock over the call: graphed "
        f"{t_g / new * 1e3:.2f} ms/token ({graph_note(r_g)}), eager step "
        f"loop {t_e / new * 1e3:.2f} ms/token; graphed ids and logits "
        f"bitwise equal to the eager loop's: {same}; logits finite: {finite}")
    if not (same and finite and lg_g.shape == (new, 1, cfg.vocab_size)):
        raise AssertionError(f"{tag}: graphed run differs from the eager "
                             "loop, or its logits are not finite")
    return launches, t_g / new * 1e3, r_g


def phase_neox20b():
    """(i) GPT-NeoX-20B E8P12 nibble at full width and all 44 layers
    (random codes, seed 0, quantized head; phase 18)."""
    import gc
    import numpy as np
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig.from_hf_config(NEOX_20B_HF)
    L = cfg.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    torch.cuda.synchronize()
    log(f"neox20b: built GPT-NeoX-20B E8P12 ({L} layers, hidden "
        f"{cfg.hidden_size}, rotary dims 24 of {cfg.head_dim}; random codes, "
        f"seed 0, quantized head) in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, NEW, CACHE = 32, 32, 2048
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    k1, dense = family_routes("neox20b", cfg, model, prompt, CACHE)
    if (k1, dense) != (4 * L + 1, 0):
        raise AssertionError(f"neox20b: {k1} K1 linears and {dense} dense "
                             f"ones, expected {4 * L + 1} and 0")
    launches, ms_tok, _ = graphed_vs_eager("neox20b", cfg, model, prompt,
                                           NEW, CACHE, k1)
    for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        check_plain(cfg, model, prompt, dt, tol, CACHE, tag="neox20b",
                    per_step={"fused_decode_matmul": k1})
    dev_ms, eager_ms = decode_step_device_ms(cfg, model, prompt, CACHE)
    pre_ms, pre_eager = prefill_device_ms(cfg, model, prompt, CACHE)
    rows, err = k1_rows(NEOX_SHAPES, torch.Generator(
        device="cuda").manual_seed(2), two_sets=())
    per = {key: call_sum(rows, NEOX_CALLS, key, m=1, sets=1)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    pre = {key: call_sum(rows, NEOX_CALLS, key, m=32, sets=1)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"neox20b: one decode step (position {S}): device time {dev_ms:.2f} "
        f"ms (CUDA-graph replay), eager {eager_ms:.2f} ms -> device idle "
        f"{1 - dev_ms / eager_ms:.0%}; K1 per token (m = 1, {k1} calls) "
        f"{per['ms']:.3f} ms, bound {per['bound_ms']:.3f} ms "
        f"({per['bound_ms'] / per['ms']:.0%} of it), library "
        f"{per['library_ms']:.3f} ms; the step outside K1 "
        f"{dev_ms - per['ms']:.2f} ms; the {S}-token prefill: device time "
        f"{pre_ms:.2f} ms (eager {pre_eager:.2f}), K1 at m = 32 "
        f"{pre['ms']:.3f} ms (bound {pre['bound_ms']:.3f})")

    # serving: 4 requests at 4 slots in f32 (a prefill chunk of 4 x 128
    # rows runs K2, a decode step of 4 rows K1), each request's ids held to
    # f32 generate of its prompt alone
    f32 = {"compute_dtype": torch.float32}
    reqs = [(p, 16) for p, _ in serving_requests(cfg, 4, 0, (16, 128),
                                                 (16, 16))]
    outs, st, eng = serve("neox20b serving f32", cfg, model, reqs,
                          max_batch=4, cache_len=CACHE, prefill_chunk=128,
                          decode_chunk=8, dtype=torch.float32, linear_kw=f32)
    check_serving_launches("neox20b serving f32", st,
                           {"fused_decode_matmul_tc": k1},
                           {"fused_decode_matmul": k1})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    same = 0
    for (p, m), got in zip(reqs, outs):
        want = qt.generate(cfg, model, torch.as_tensor(p)[None].cuda(), m,
                           cache_len=CACHE, dtype=torch.float32,
                           linear_kw=f32)[0].cpu().numpy()
        same += int(np.array_equal(got, want))
    log(f"neox20b serving f32: {same}/4 requests' ids equal f32 generate of "
        "the prompt alone")
    if same != 4:
        raise AssertionError("neox20b: f32 serving differs from generate")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches["fused_decode_matmul"], "k1_per_token": k1,
            "ms_tok": ms_tok, "dev_ms": dev_ms, "eager_ms": eager_ms,
            "prefill_device_ms": pre_ms, "kernel_ms_token": per["ms"],
            "kernel_bound_ms_token": per["bound_ms"],
            "kernel_library_ms_token": per["library_ms"],
            "kernel_max_err": err, "serving": st}


def phase_families():
    """(ii) GPT-2, OPT, Falcon, Phi, GPT-J, QWen and Baichuan at their
    published widths, FAMILY_LAYERS layers each (random E8P12 codes, seed
    0, quantized head where untied and V % 128 == 0; QWen and Baichuan
    fused): K1 launches and dense-route linears per forward against the
    widths rule, graphed ``generate`` of 8 tokens against the eager loop,
    and f32 logits against the plain route."""
    import dataclasses
    import gc
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.models.config import ModelConfig
    out = {}
    for source, hf in FAMILY_HF.items():
        cfg = dataclasses.replace(ModelConfig.from_hf_config(hf),
                                  num_hidden_layers=FAMILY_LAYERS)
        tag = f"{cfg.arch} ({source})"
        t = time.time()
        model = qt.fuse_for_inference(cfg, qt.random_quantized_model(
            cfg, seed=0, dtype=torch.bfloat16, quantize_head=True,
            device="cuda"))
        torch.cuda.synchronize()
        depth = hf.get("num_hidden_layers", hf.get("n_layer"))
        log(f"{tag}: built at hidden {cfg.hidden_size}, intermediate "
            f"{cfg.intermediate_size}, {cfg.num_attention_heads} heads "
            f"({cfg.num_key_value_heads} kv), vocab {cfg.vocab_size}, "
            f"{FAMILY_LAYERS} of {depth} layers in {time.time() - t:.1f} s")
        prompt = torch.randint(0, cfg.vocab_size, (1, 16), device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(0))
        k1, dense = family_routes(tag, cfg, model, prompt, 512)
        launches, ms_tok, _ = graphed_vs_eager(tag, cfg, model, prompt, 8,
                                               512, k1)
        check_plain(cfg, model, prompt, torch.float32, 1e-3, 512, n=8,
                    tag=tag, per_step={"fused_decode_matmul": k1})
        out[source] = {"arch": cfg.arch, "k1_per_forward": k1,
                       "dense_per_forward": dense,
                       "launches": launches["fused_decode_matmul"],
                       "ms_tok": ms_tok}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_rowpair_kernels():
    """The row-pair kernels against their plain twins at Llama-2-7B's
    shapes, timed as phase 2 times fused_decode_matmul, and beside
    fused_decode_matmul on the nibble planes of the same codes."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops import qtensor as Q
    from quip_for_all_tpu_torch.ops import rowpair_matmul as rm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = [], {}
    for layout, codebook, kname in ROWPAIR:
        max_err[kname] = 0.0
        for name, q_out, q_in, with_scale, _ in SHAPES[:5]:
            qrp = random_qtensor(codebook, layout, q_out, q_in, gen, "cuda")
            qn = (Q.u3_to_nibble if layout == "u3" else Q.pb_to_nibble)(qrp)
            Gp, Gn = qrp.group_cols, qn.group_cols
            rs = qrp.opt_resid_scale

            def kernel(x, planes, scale, m):
                if layout == "u3":
                    return rm.rowpair_u3_matmul(x, planes, scale, rows=m)
                return rm.rowpair_pb_matmul(x, planes, rs, scale, rows=m)
            plane_bytes = sum(v.numel() * 4 for v in qrp.planes.values())
            nib_bytes = sum(v.numel() * 4 for v in qn.planes.values())
            copies = max(2, math.ceil(2 * tm.L2_BYTES / plane_bytes))
            rps = [qrp.planes] + [{k: v.clone() for k, v in qrp.planes.items()}
                                  for _ in range(copies - 1)]
            ncopies = max(2, math.ceil(2 * tm.L2_BYTES / nib_bytes))
            nibs = [qn.plane_list()] + [[v.clone() for v in qn.plane_list()]
                                        for _ in range(ncopies - 1)]
            scale = (torch.rand(q_out, generator=gen, device="cuda") + 0.5
                     if with_scale else None)
            W = decode_weights(qrp, dtype=torch.bfloat16)
            w_copies = max(2, math.ceil(2 * tm.L2_BYTES / (W.numel() * 2)))
            Ws = [W] + [W.clone() for _ in range(w_copies - 1)]
            for m, dt in RP_CASES:
                dtype = getattr(torch, dt)
                mp = max(8, -(-m // 8) * 8)
                x_nat = torch.randn((m, q_in), generator=gen, device="cuda")
                x = torch.zeros((mp, 8 * Gp), device="cuda", dtype=dtype)
                x[:m] = fm.grouped_permute(x_nat, Gp).to(dtype)
                xn = torch.zeros((mp, 8 * Gn), device="cuda", dtype=dtype)
                xn[:m] = fm.grouped_permute(x_nat, Gn).to(dtype)
                got = kernel(x, qrp.planes, scale, m)
                want = rm.rowpair_matmul_ref(x, layout, qrp.planes, rs, scale,
                                             rows=m)
                nib = fm.fused_decode_matmul(xn, qn.plane_list(),
                                             qn.decode_affine, scale, rows=m)
                nib_want = fm.fused_decode_matmul_ref(
                    xn[:m], qn.plane_list(), qn.decode_affine, scale)
                torch.cuda.synchronize()
                ok, err = tm.compare(got, want, bf16_step=True)[:2]
                ok_n, err_n = tm.compare(nib, nib_want, bf16_step=True)[:2]
                max_err[kname] = max(max_err[kname], err)
                if not (ok and ok_n):
                    raise AssertionError(
                        f"{kname} {name} m={m} {dt}: kernel vs plain twin "
                        f"{err}; on the nibble planes of the same codes, "
                        f"fused_decode_matmul vs its twin {err_n}")
                k_ms = 1e-3 * tm.graph_us(
                    lambda i: kernel(x, rps[i % copies], scale, m),
                    4 * copies)
                n_ms = 1e-3 * tm.graph_us(lambda i: fm.fused_decode_matmul(
                    xn, nibs[i % ncopies], qn.decode_affine, scale, rows=m),
                    4 * ncopies)
                p_ms = 1e-3 * tm.event_us(lambda i: rm.rowpair_matmul_ref(
                    x, layout, rps[i % copies], rs, scale, rows=m), 3)
                xb = x_nat.to(torch.bfloat16)
                lib_ms = 1e-3 * tm.graph_us(lambda i: torch.matmul(
                    xb, Ws[i % w_copies].T), 4 * w_copies)
                esz = 2 if dtype == torch.bfloat16 else 4
                io = m * 8 * Gp * esz + m * q_out * esz + (
                    q_out * 4 if with_scale else 0)
                nbytes = plane_bytes + io
                n_bytes = nib_bytes + m * 8 * Gn * esz + m * q_out * esz + (
                    q_out * 4 if with_scale else 0)
                ops = 2 * m * q_out * 8 * Gp
                peak = tm.BF16_OPS_PER_S if dtype == torch.bfloat16 else \
                    tm.F32_OPS_PER_S
                b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
                b_ops = ops / peak * 1e3
                row = {"kernel": kname, "layout": layout, "layer": name,
                       "q_out": q_out, "Gp": Gp, "m": m, "dtype": dt,
                       "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": lib_ms, "nibble_ms": n_ms,
                       "bound_ms": max(b_bytes, b_ops),
                       "bound_by": "bytes" if b_bytes >= b_ops
                       else "operations",
                       "nibble_bound_ms": n_bytes / tm.HBM_BYTES_PER_S * 1e3,
                       "bytes": nbytes, "nibble_bytes": n_bytes}
                rows.append(row)
                log(f"kernel {layout} {name:6s} {q_out}x{Gp} m={m:2d} {dt}: "
                    f"max|k-plain| {err:.3g} (tol 1 bf16 ulp + 1e-5 max) | "
                    f"kernel {k_ms * 1e3:.1f} us | plain {p_ms * 1e3:.1f} us "
                    f"| bound {row['bound_ms'] * 1e3:.1f} us "
                    f"({row['bound_by']}, {nbytes / 1e6:.2f} MB) | "
                    f"{row['bound_ms'] / k_ms:.0%} of bound | library "
                    f"{lib_ms * 1e3:.1f} us (dense bf16 product, not the same"
                    f" function) | nibble fused_decode_matmul on the same "
                    f"codes {n_ms * 1e3:.1f} us (bound "
                    f"{row['nibble_bound_ms'] * 1e3:.1f} us, "
                    f"{n_bytes / 1e6:.2f} MB) -> {layout}/nibble "
                    f"{k_ms / n_ms:.2f}x")
            del rps, nibs, Ws, W, qrp, qn
            torch.cuda.empty_cache()
    for layout, _, kname in ROWPAIR:
        per_tok = {key: call_sum([r for r in rows if r["kernel"] == kname],
                                 LLAMA_CALLS, key, m=1, dtype="bfloat16")
                   for key in ("ms", "nibble_ms", "bound_ms",
                               "nibble_bound_ms")}
        log(f"kernel {kname} per Llama-2-7B decode token (m=1, bf16, 129 "
            f"calls): {per_tok['ms']:.3f} ms against a "
            f"{per_tok['bound_ms']:.3f} ms bound; fused_decode_matmul on "
            f"the nibble planes of the same "
            f"codes {per_tok['nibble_ms']:.3f} ms against "
            f"{per_tok['nibble_bound_ms']:.3f} ms")
        for m in (8, 32, 64):
            per = {key: call_sum([r for r in rows if r["kernel"] == kname],
                                 LLAMA_CALLS, key, m=m, dtype="bfloat16")
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                               "nibble_ms")}
            log(f"kernel {kname} per Llama-2-7B "
                f"{'token' if m <= 8 else 'prefill'} at m={m} (bf16, 129 "
                f"calls): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in per.items()))
    return rows, max_err


def phase_rowpair_paths():
    """Llama-2-7B at full width and all 32 layers in the byte-cut layouts:
    (a) E8P12 u3 and (b) E8P12RVQ4B pb through the row-pair kernels, (c)
    E8P12RVQ4B nibble through fused_decode_matmul with 2 plane sets. Each
    path runs with the launch counts set to 0 just before and read just
    after. Returns {path: launches, step times}."""
    import gc
    import torch
    import quip_for_all_tpu_torch as qt
    cfg = qt.llama2_7b_config()
    S, NEW, CACHE = 32, 32, 2048
    per_step = 4 * LAYERS + 1
    out = {}
    for tag, codebook, layout, kname in (
            ("a_u3", "E8P12", "u3", "rowpair_u3_decode_matmul"),
            ("b_pb", "E8P12RVQ4B", "pb", "rowpair_pb_decode_matmul"),
            ("c_rvq4b_nibble", "E8P12RVQ4B", None, "fused_decode_matmul")):
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        model = qt.random_quantized_model(cfg, codebook, seed=0,
                                          dtype=torch.bfloat16,
                                          quantize_head=True, device="cuda",
                                          layout=layout)
        model = qt.fuse_for_inference(cfg, model)
        torch.cuda.synchronize()
        log(f"{tag}: built Llama-2-7B {codebook} [{layout or 'nibble'}] "
            f"(random codes, seed 0, fused, quantized head) in "
            f"{time.time() - t:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card "
            f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
        gen = torch.Generator(device="cuda").manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                               device="cuda")
        run = timed_generate(cfg, model, prompt, CACHE)
        run(4)                                       # warm-up
        (_, _), t_pre = run(1)                       # prefill only
        reset_launches()
        (ids1, logits1), t1 = run(NEW)
        launches = read_launches()
        fwd = forwards(run.runner)
        (ids2, _), t2 = run(NEW)
        ms_tok = (t1 - t_pre) / (NEW - 1) * 1e3
        log(f"{tag}: prompt {S} + {NEW} greedy tokens, cache_len {CACHE}: "
            f"prefill {t_pre * 1e3:.1f} ms, decode {ms_tok:.2f} ms/token "
            f"({1e3 / ms_tok:.1f} tok/s); second run "
            f"{(t2 - t_pre) / (NEW - 1) * 1e3:.2f} ms/token; "
            f"{graph_note(run.runner)}")
        check_launches(tag, launches, {kname: per_step * fwd})
        check_runs(tag, cfg, ids1, ids2, logits1, NEW)
        for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
            check_plain(cfg, model, prompt, dt, tol, CACHE, tag=tag,
                        per_step={kname: per_step})
        dev_ms, eager_ms = decode_step_device_ms(cfg, model, prompt, CACHE)
        log(f"{tag}: one decode step (position {S}): device time "
            f"{dev_ms:.2f} ms (CUDA-graph replay), eager {eager_ms:.2f} ms "
            f"-> device idle {1 - dev_ms / eager_ms:.0%} of the eager step")
        pre_ms = log_prefill(tag, cfg, model, prompt, CACHE, kname)
        out[tag] = {"kernel": kname, "launches": launches[kname],
                    "ms_tok": ms_tok, "dev_ms": dev_ms, "eager_ms": eager_ms,
                    "prefill_device_ms": pre_ms}
        if tag == "c_rvq4b_nibble":
            out[tag]["right_combine"] = right_combine_path(
                "17 iv", cfg, model, prompt, dev_ms)
        del model, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_layout_kernels():
    """K10 (bfp, 1 and 2 plane sets), K11 (sw2, sw4), K6 (split-K at 2 and
    4 chunks; down at 11, the only split its 11 lane blocks allow) and K7
    (paired) against their plain twins at Llama-2-7B's shapes, m = 1, 8,
    32 and 64 in bf16 and m = 1 in f32, timed as phase 2 times
    fused_decode_matmul. All run on one set of random RVQ4B codes per
    shape: its main stage is the E8P12 code of K10/K11/K6 (1 set) and K1
    beside them; both stages are K10's 2 sets, K7's paired planes, and K1
    (2 sets) and K8 (pb) beside K7."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops import layout_matmul as lm
    from quip_for_all_tpu_torch.ops import qtensor as Q
    from quip_for_all_tpu_torch.ops import rowpair_matmul as rm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, max_err = [], {}
    for name, q_out, q_in, with_scale, _ in SHAPES[:5]:
        G = q_in // 8
        qp = random_qtensor("E8P12RVQ4B", "paired", q_out, q_in, gen, "cuda")
        qn2 = Q.paired_to_nibble(qp)
        u0, p0, u1, p1 = (t[:, :G] for t in Q.paired_uv_from_planes(
            qp.planes))
        qpb = Q.QuantizedTensor(Q.pb_planes_from_uv(u0, p0, u1, p1, q_out, G),
                                "E8P12RVQ4B", q_out, q_in,
                                qp.opt_resid_scale, "pb")
        del u0, p0, u1, p1
        qn1 = Q.QuantizedTensor({"w0": qn2.planes["w0"]}, "E8P12", q_out,
                                q_in)
        a1, a2, rs = qn1.decode_affine, qn2.decode_affine, qp.opt_resid_scale
        chunks = (2, 4) if name != "down" else (11,)
        # (label, kernel, codes, tensor, call(x, planes, scale, m),
        #  twin(x, planes, scale, m), split of x's lane order)
        variants = [
            ("bfp", "bfp_decode_matmul", 1, Q.to_bfp(qn1),
             lambda x, p, s, m: lm.bfp_decode_matmul(x, p, a1, s, rows=m),
             lambda x, p, s, m: lm.bfp_decode_matmul_ref(x[:m], p, a1, s)),
            ("bfp2", "bfp_decode_matmul", 2, Q.to_bfp(qn2),
             lambda x, p, s, m: lm.bfp_decode_matmul(x, p, a2, s, rows=m),
             lambda x, p, s, m: lm.bfp_decode_matmul_ref(x[:m], p, a2, s)),
            ("sw2", "sw_decode_matmul", 1, Q.to_subword(qn1, 2),
             lambda x, p, s, m: lm.sw_decode_matmul(x, p, a1, s, rows=m),
             lambda x, p, s, m: lm.sw_decode_matmul_ref(x[:m], p, a1, s)),
            ("sw4", "sw_decode_matmul", 1, Q.to_subword(qn1, 4),
             lambda x, p, s, m: lm.sw_decode_matmul(x, p, a1, s, rows=m),
             lambda x, p, s, m: lm.sw_decode_matmul_ref(x[:m], p, a1, s)),
        ] + [
            (f"ksplit{c}", "ksplit_decode_matmul", 1, qn1,
             (lambda c: lambda x, p, s, m: lm.ksplit_decode_matmul(
                 x, p, a1, c, s, rows=m))(c),
             (lambda c: lambda x, p, s, m: lm.ksplit_decode_matmul_ref(
                 x[:m], p, a1, c, s))(c)) for c in chunks
        ] + [
            ("paired", "paired_decode_matmul", 2, qp,
             lambda x, p, s, m: rm.paired_decode_matmul(x, p, rs, s, rows=m),
             lambda x, p, s, m: rm.rowpair_matmul_ref(x, "paired", p, rs, s,
                                                      rows=m))]
        # beside them on the same codes, timed only (checked in phases 2, 7)
        beside = [
            ("nibble", qn1, lambda x, p, s, m: fm.fused_decode_matmul(
                x, p, a1, s, rows=m)),
            ("nibble2", qn2, lambda x, p, s, m: fm.fused_decode_matmul(
                x, p, a2, s, rows=m)),
            ("pb", qpb, lambda x, p, s, m: rm.rowpair_pb_matmul(
                x, p, rs, s, rows=m))]

        def planes_of(qt):
            return qt.planes if qt.layout in Q.UCODE_LAYOUTS else \
                qt.plane_list()

        def nbytes_of(qt):
            return sum(v.numel() * v.element_size()
                       for v in qt.planes.values())
        tensors = {id(v[3]): v[3] for v in variants}
        tensors.update({id(qt): qt for _, qt, _ in beside})
        copies = {i: tm.cold_copies(planes_of(qt))
                  for i, qt in tensors.items()}
        scale = (torch.rand(q_out, generator=gen, device="cuda") + 0.5
                 if with_scale else None)
        Ws = {codes: decode_weights(qt, dtype=torch.bfloat16)
              for codes, qt in ((1, qn1), (2, qn2))}
        Wc = {c: tm.cold_copies([W]) for c, W in Ws.items()}
        for m, dt in RP_CASES:
            dtype = getattr(torch, dt)
            esz = 2 if dtype == torch.bfloat16 else 4
            mp = max(8, -(-m // 8) * 8)
            x_nat = torch.randn((m, q_in), generator=gen, device="cuda")
            xb = x_nat.to(torch.bfloat16)

            def xperm(qt):
                x = torch.zeros((mp, 8 * qt.group_cols), device="cuda",
                                dtype=dtype)
                x[:m] = fm.grouped_permute(x_nat, qt.group_cols,
                                           qt.split).to(dtype)
                return x
            lib_ms = {c: 1e-3 * tm.graph_us(lambda i, c=c: torch.matmul(
                xb, Wc[c][i % len(Wc[c])][0].T), 4 * len(Wc[c]))
                for c in Wc}
            side = {}
            for label, qt, call in beside:
                x, cp = xperm(qt), copies[id(qt)]
                side[label] = 1e-3 * tm.graph_us(
                    lambda i: call(x, cp[i % len(cp)], scale, m),
                    4 * len(cp))
            for label, kname, codes, qt, call, twin in variants:
                x, cp = xperm(qt), copies[id(qt)]
                got = call(x, cp[0], scale, m)
                want = twin(x, cp[0], scale, m)
                torch.cuda.synchronize()
                ok, err = tm.compare(got, want, bf16_step=True)[:2]
                max_err[kname] = max(max_err.get(kname, 0.0), err)
                if not ok:
                    raise AssertionError(
                        f"{kname} ({label}) {name} m={m} {dt}: kernel vs "
                        f"plain twin beyond tolerance (max |diff| {err})")
                k_ms = 1e-3 * tm.graph_us(
                    lambda i: call(x, cp[i % len(cp)], scale, m),
                    4 * len(cp))
                p_ms = 1e-3 * tm.event_us(
                    lambda i: twin(x, cp[i % len(cp)], scale, m), 2)
                nb = nbytes_of(qt)
                io = m * 8 * qt.group_cols * esz + m * q_out * esz + (
                    q_out * 4 if with_scale else 0)
                ops = 2 * m * q_out * 8 * qt.group_cols
                peak = tm.BF16_OPS_PER_S if dtype == torch.bfloat16 else \
                    tm.F32_OPS_PER_S
                b_bytes = (nb + io) / tm.HBM_BYTES_PER_S * 1e3
                b_ops = ops / peak * 1e3
                ref = {1: "nibble", 2: "nibble2"}[codes]
                row = {"kernel": kname, "variant": label, "layer": name,
                       "q_out": q_out, "Gp": qt.group_cols, "m": m,
                       "dtype": dt, "max_abs_err": err, "ms": k_ms,
                       "plain_ms": p_ms, "library_ms": lib_ms[codes],
                       "bound_ms": max(b_bytes, b_ops),
                       "bound_by": "bytes" if b_bytes >= b_ops
                       else "operations", "bytes": nb + io,
                       "nibble_ms": side[ref], "pb_ms": side["pb"]}
                rows.append(row)
                extra = (f" | pb (K8) on the same codes {side['pb'] * 1e3:.1f}"
                         f" us" if label == "paired" else "")
                log(f"kernel {label} {name:6s} {q_out}x{qt.group_cols} "
                    f"m={m:2d} {dt}: max|k-plain| {err:.3g} (tol 1 bf16 ulp "
                    f"+ 1e-5 max) | kernel {k_ms * 1e3:.1f} us | plain "
                    f"{p_ms * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.1f}"
                    f" us ({row['bound_by']}, {(nb + io) / 1e6:.2f} MB) | "
                    f"{row['bound_ms'] / k_ms:.0%} of bound | library "
                    f"{lib_ms[codes] * 1e3:.1f} us (dense bf16 product) | "
                    f"fused_decode_matmul ({codes} set{'s' * (codes > 1)}) "
                    f"on the same codes {side[ref] * 1e3:.1f} us -> "
                    f"{label}/nibble {k_ms / side[ref]:.2f}x{extra}")
        del copies, tensors, Ws, Wc, variants, beside, qp, qn1, qn2, qpb
        torch.cuda.empty_cache()
    for label, calls in (("bfp", LLAMA_CALLS), ("bfp2", LLAMA_CALLS),
                         ("sw2", LLAMA_CALLS), ("sw4", LLAMA_CALLS),
                         ("ksplit4", KSPLIT_CALLS),
                         ("paired", LLAMA_CALLS)):
        per_tok = {key: call_sum([r for r in rows if r["variant"] == label],
                                 calls, key, m=1, dtype="bfloat16")
                   for key in ("ms", "nibble_ms", "bound_ms", "pb_ms")}
        log(f"kernel {label} per Llama-2-7B decode token (m=1, bf16, "
            f"{sum(calls.values())} calls): {per_tok['ms']:.3f} ms against a "
            f"{per_tok['bound_ms']:.3f} ms bound; fused_decode_matmul on the "
            f"same codes {per_tok['nibble_ms']:.3f} ms" + (
                f"; pb (K8) {per_tok['pb_ms']:.3f} ms"
                if label == "paired" else ""))
    # beyond decode: per token at m = 8, per 32- and 64-token prefill
    for label, calls in (("bfp", LLAMA_CALLS), ("sw2", LLAMA_CALLS),
                         ("sw4", LLAMA_CALLS), ("ksplit4", KSPLIT_CALLS),
                         ("paired", LLAMA_CALLS)):
        for m in (8, 32, 64):
            per = {key: call_sum([r for r in rows if r["variant"] == label],
                                 calls, key, m=m, dtype="bfloat16")
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                               "nibble_ms")}
            log(f"kernel {label} per Llama-2-7B "
                f"{'token' if m <= 8 else 'prefill'} at m={m} (bf16, "
                f"{sum(calls.values())} calls): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in per.items()))
    return rows, max_err


def relayout_model(model, fn):
    """Every quantized linear's planes through ``fn`` (QuantizedTensor ->
    QuantizedTensor of the same plane keys), in place: the buffers are
    replaced one linear at a time, so a copying re-layout holds one extra
    linear's planes at most."""
    from quip_for_all_tpu_torch.nn.qlinear import (FusedQuantLinear,
                                                   QuantLinear)
    for mod in model.modules():
        if isinstance(mod, (QuantLinear, FusedQuantLinear)) and \
                mod.plane_keys:
            qt = fn(mod.qweight)
            for k in mod.plane_keys:
                setattr(mod, f"planes_{k}", qt.planes[k])
            mod.layout = qt.layout


def f32_logits(cfg, model, prompt, n=4):
    import torch
    import quip_for_all_tpu_torch as qt
    ids, logits = qt.generate(cfg, model, prompt, n, cache_len=2048,
                              dtype=torch.float32, return_logits=True,
                              linear_kw={"compute_dtype": torch.float32})
    return ids, torch.stack(logits)


def run_path(tag, cfg, model, prompt, expect, NEW=32, CACHE=2048):
    """One full-width path: a 32-token prompt and NEW greedy tokens twice,
    exact launch counts (``expect``: launches per forward pass), the
    kernel-vs-plain check in bf16 and f32, and one graphed decode step."""
    import torch
    S = prompt.shape[1]
    run = timed_generate(cfg, model, prompt, CACHE)
    run(4)                                           # warm-up
    (_, _), t_pre = run(1)                           # prefill only
    reset_launches()
    (ids1, logits1), t1 = run(NEW)
    launches = read_launches()
    fwd = forwards(run.runner)
    (ids2, _), t2 = run(NEW)
    ms_tok = (t1 - t_pre) / (NEW - 1) * 1e3
    log(f"{tag}: prompt {S} + {NEW} greedy tokens, cache_len {CACHE}: "
        f"prefill {t_pre * 1e3:.1f} ms, decode {ms_tok:.2f} ms/token "
        f"({1e3 / ms_tok:.1f} tok/s); second run "
        f"{(t2 - t_pre) / (NEW - 1) * 1e3:.2f} ms/token; "
        f"{graph_note(run.runner)}")
    check_launches(tag, launches, {k: v * fwd for k, v in expect.items()})
    check_runs(tag, cfg, ids1, ids2, logits1, NEW)
    for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        check_plain(cfg, model, prompt, dt, tol, CACHE, tag=tag,
                    per_step=expect)
    dev_ms, eager_ms = decode_step_device_ms(cfg, model, prompt, CACHE)
    log(f"{tag}: one decode step (position {S}): device time "
        f"{dev_ms:.2f} ms (CUDA-graph replay), eager {eager_ms:.2f} ms "
        f"-> device idle {1 - dev_ms / eager_ms:.0%} of the eager step; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    return {"launches": launches, "ms_tok": ms_tok, "dev_ms": dev_ms,
            "eager_ms": eager_ms}


def phase_layout_paths(main):
    """Llama-2-7B at full width and all 32 layers through the new kernels:
    (f) the main path's E8P12 nibble planes (``main``, whose model this
    phase takes and frees) with split-K = 4, (e) the same planes re-laid as
    sw4 (a view) and (d) as bfp (copied one linear at a time), each held to
    the main path's f32 logits (K1), then (g) E8P12RVQ4B in the paired
    layout built from seed 0. Per forward pass:
    (d) 129 K10, (e) 129 K11, (f) 97 K6 (qkv, o, gate/up, head) and 32 K1
    (down's 11 lane blocks do not split 4 ways), (g) 129 K7; the 32-token
    prefill has padded m 32, so split-K runs there too."""
    import gc
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.ops import qtensor as Q
    cfg, prompt, ref = main["cfg"], main["prompt"], main["ref"]
    model = main.pop("model")
    per_step = 4 * LAYERS + 1
    out = {}
    for tag, expect, to, back in (
            ("f_ksplit4", {"ksplit_decode_matmul": 3 * LAYERS + 1,
                           "fused_decode_matmul": LAYERS},
             lambda: qt.set_ksplit(model, 4), lambda: qt.set_ksplit(model, 0)),
            ("e_sw4", {"sw_decode_matmul": per_step},
             lambda: relayout_model(model, lambda q: Q.to_subword(q, 4)),
             lambda: relayout_model(model, Q.from_subword)),
            ("d_bfp", {"bfp_decode_matmul": per_step},
             lambda: relayout_model(model, Q.to_bfp),
             lambda: relayout_model(model, Q.from_bfp))):
        t = time.time()
        to()
        torch.cuda.synchronize()
        log(f"{tag}: re-laid the main path's Llama-2-7B planes in "
            f"{time.time() - t:.1f} s")
        _, lg = f32_logits(cfg, model, prompt)
        rel = float((lg - ref).abs().max() / ref.abs().max())
        log(f"{tag}: f32 logits of the prompt and 3 greedy steps against the "
            f"main path's fused_decode_matmul run: max|diff|/max|logit| "
            f"{rel:.3g} (tol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"{tag}: f32 logits differ from K1's by "
                                 f"{rel}")
        out[tag] = run_path(tag, cfg, model, prompt, expect)
        out[tag]["prefill_device_ms"] = log_prefill(
            tag, cfg, model, prompt, 2048, ", ".join(expect))
        back()
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.random_quantized_model(cfg, "E8P12RVQ4B", seed=0,
                                      dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda",
                                      layout="paired")
    model = qt.fuse_for_inference(cfg, model)
    torch.cuda.synchronize()
    log(f"g_paired: built Llama-2-7B E8P12RVQ4B [paired] (random codes, seed"
        f" 0, fused, quantized head) in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card "
        f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
    out["g_paired"] = run_path("g_paired", cfg, model, prompt,
                               {"paired_decode_matmul": per_step})
    out["g_paired"]["prefill_device_ms"] = log_prefill(
        "g_paired", cfg, model, prompt, 2048, "paired_decode_matmul")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_step_device_ms(cfg, model, prompt, cache_len, n=20):
    """Device time of one bf16 decode step: the step captured once in a
    CUDA graph and replayed n times between CUDA events (no host dispatch),
    beside the same step run eagerly n times: what one step of
    ``generate``'s graphed loop spends on the device, alone."""
    import torch
    from quip_for_all_tpu_torch.models.registry import get_arch
    from quip_for_all_tpu_torch.runtime.generate import (attn_bucket,
                                                         init_kv_caches)
    M = get_arch(cfg)
    S = prompt.shape[1]
    caches = init_kv_caches(cfg, 1, cache_len, torch.bfloat16, "cuda")
    M.model_apply(cfg, model, prompt, kv_caches=caches, cache_position=0,
                  dtype=torch.bfloat16, attn_window=attn_bucket(S, cache_len))
    tok, pos = prompt[:, -1:], torch.full((1, 1), S, device="cuda")
    w = attn_bucket(S + 1, cache_len)

    def step(_):
        return M.model_apply(cfg, model, tok, positions=pos,
                             kv_caches=caches, cache_position=S,
                             dtype=torch.bfloat16, attn_window=w)[0]
    eager = 1e-3 * tm.event_us(step, n)
    return 1e-3 * tm.graph_us(step, 1, reps=n), eager


def prefill_device_ms(cfg, model, prompt, cache_len, n=10):
    """Device time of the bf16 prefill of ``prompt`` (the cache written at
    positions 0..S-1, as generate's first step): captured once in a CUDA
    graph and replayed n times between CUDA events, beside the same
    prefill run eagerly n times."""
    import torch
    from quip_for_all_tpu_torch.models.registry import get_arch
    from quip_for_all_tpu_torch.runtime.generate import (attn_bucket,
                                                         init_kv_caches)
    M = get_arch(cfg)
    S = prompt.shape[1]
    caches = init_kv_caches(cfg, 1, cache_len, torch.bfloat16, "cuda")
    w = attn_bucket(S, cache_len)

    def step(_):
        return M.model_apply(cfg, model, prompt, kv_caches=caches,
                             cache_position=0, dtype=torch.bfloat16,
                             attn_window=w)[0]
    eager = 1e-3 * tm.event_us(step, n)
    return 1e-3 * tm.graph_us(step, 1, reps=n), eager


def log_prefill(tag, cfg, model, prompt, cache_len, kname):
    """A path's bf16 prefill of ``prompt``: its device time by CUDA-graph
    replay, logged beside the eager time. Returns the device ms."""
    pre_ms, pre_eager = prefill_device_ms(cfg, model, prompt, cache_len)
    log(f"{tag}: the {prompt.shape[1]}-token prefill ({kname} at m = "
        f"{prompt.shape[1]}): device time {pre_ms:.2f} ms (CUDA-graph "
        f"replay), eager {pre_eager:.2f} ms -> device idle "
        f"{1 - pre_ms / pre_eager:.0%} of the eager prefill")
    return pre_ms


@contextlib.contextmanager
def shared_routing(model, k, logits, replay):
    """While active, every MoE block's router logits (its dense gate's
    output) are appended to ``logits`` call by call, or, with ``replay``,
    replaced by those recorded, so that a second generate run takes the
    first run's top-k experts and weights. Yields a one-element list that
    counts, on replay, the token-layer choices whose top-k set the run's
    own logits would have changed."""
    import torch
    from quip_for_all_tpu_torch.models import llama as M
    gates = {id(b["block_sparse_moe"]["gate"]) for b in model.layers}
    orig, recorded, flips = M.linear_apply, iter(list(logits)), [0]

    def linear_apply(lin, x, **kw):
        y = orig(lin, x, **kw)
        if id(lin) not in gates:
            return y
        if not replay:
            logits.append(y)
            return y
        r = next(recorded)
        own, rec = (torch.topk(t.float(), k, dim=-1).indices.sort(
            dim=-1).values for t in (y, r))
        flips[0] = flips[0] + (own != rec).any(dim=-1).sum()
        return r
    M.linear_apply = linear_apply
    try:
        yield flips
    finally:
        M.linear_apply = orig
        flips[0] = int(flips[0])


def check_plain(cfg, model, prompt, dtype, tol, cache_len, n=16,
                tag="main", per_step=None):
    """The first decode step's logits and n greedy tokens with every linear
    on the kernel vs on the plain twin. A greedy fork is accepted only at a
    near-tie: the kernel's token within tol*max|logit| of the plain max.
    When the runs fork at the prompt's own token (a near-tie there), the
    first decode steps see different tokens, and the prompt's logits (the
    same inputs in both runs) are held to tol instead. ``per_step`` names
    the path's kernels with their launches per step, which the kernel run
    must show n times over. Both runs are the port's step loop run
    eagerly (the plain MoE twin reads expert ids on the host, which a
    CUDA graph cannot hold). On an MoE model the kernel run takes the plain run's routing
    (``shared_routing``): the runs then differ by the linears' rounding and
    not by a top-k choice that a near-tie of router logits flips, and the
    MoE kernel runs on every decode step of the kernel run."""
    import torch
    from quip_for_all_tpu_torch.runtime import generate as G
    S = prompt.shape[1]
    moe = cfg.arch == "mixtral"
    outs, router = {}, []
    for impl in ("plain", "auto"):
        ctx = (shared_routing(model, cfg.num_experts_per_tok, router,
                              replay=impl == "auto")
               if moe else contextlib.nullcontext([0]))
        reset_launches()
        with ctx as flips:
            outs[impl] = G._generate(cfg, model, prompt, n,
                                     cache_len=cache_len, dtype=dtype,
                                     return_logits=True, graphs=False,
                                     linear_kw={"compute_dtype": dtype,
                                                "matmul_impl": impl})[:2]
    launches = read_launches()
    (ids_k, lk), (ids_p, lp) = outs["auto"], outs["plain"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    k_toks, p_toks = ids_k[0, S:], ids_p[0, S:]
    same = int((k_toks == p_toks).long().cumprod(0).sum())
    d0 = rel(lk[0], lp[0])
    d1 = rel(lk[1], lp[1]) if same >= 1 else None
    gap = 0.0
    if same < n:
        row = lp[same][0]
        gap = float((row.max() - row[k_toks[same]]) / row.abs().max())
    label = str(dtype).replace("torch.", "")
    log(f"{tag} [{label}]: kernel vs plain twin, max|diff|/max|logit|: "
        f"prompt logits {d0:.3g}, first decode step logits " + (
            f"{d1:.3g}" if d1 is not None else
            "not compared (the runs forked at the prompt's token)")
        + f" (tol {tol}); greedy tokens equal for {same}/{n} steps" + (
            f"; at step {same} the kernel's token is {gap:.3g} of "
            f"max|logit| below the plain argmax (tol {tol})"
            if same < n else ""))
    for kernel, k in (per_step or {}).items():
        log(f"{tag} [{label}]: {launches[kernel]} {kernel} launches in the "
            f"kernel run (expected {k * n})")
        if launches[kernel] != k * n:
            raise AssertionError(f"{tag} {label}: launches {launches}")
    if moe:
        L = len(model.layers)
        log(f"{tag} [{label}]: the kernel run took the plain run's top-"
            f"{cfg.num_experts_per_tok} routing ({flips[0]} of "
            f"{(S + n - 1) * L} token-layer choices would have differed); "
            f"{launches['moe_decode_matmul']} moe_decode_matmul launches "
            f"(expected {(n - 1) * 2 * L})")
        if launches["moe_decode_matmul"] != (n - 1) * 2 * L:
            raise AssertionError(f"{tag} {label}: launches {launches}")
    if not ((d1 if d1 is not None else d0) <= tol and gap <= tol):
        raise AssertionError(f"{tag} {label}: kernel path differs from the "
                             "plain twin beyond tolerance")


def phase_k3_kernels():
    """fused_decode_matmul_bwd (K3) against its plain twin at Llama-2-7B's
    unfused shapes, with the rows a LoRA step gives it (m = 1022 at batch
    2 x 512; 1 and 64 beside), in bf16 and f32, with 1 and 2 plane sets,
    no scale vector (the path's linears have none). Timed as phase 2
    times K1, beside the library product gs @ W with W decoded beforehand
    in g's dtype (natural order, not the same function). The bound counts
    the planes, g and dx once each, and 2*m*q_out*q_in operations at the
    peak rate of g's dtype."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, max_err = [], 0.0
    for name, q_out, q_in in K3_SHAPES:
        G = q_in // 8
        qt2 = random_qtensor("E8P12RVQ4B", None, q_out, q_in, gen, "cuda")
        for n_sets in (1, 2):
            qt = qt2 if n_sets == 2 else QuantizedTensor(
                {"w0": qt2.planes["w0"]}, "E8P12", q_out, q_in)
            planes, affine, Gp = qt.plane_list(), qt.decode_affine, \
                qt.group_cols
            nb = sum(w.numel() * 4 for w in planes)
            cp = tm.cold_copies(planes)
            for dt in ("bfloat16", "float32"):
                dtype = getattr(torch, dt)
                esz = 2 if dtype == torch.bfloat16 else 4
                W = decode_weights(qt, dtype=dtype)
                Wc = tm.cold_copies([W])
                for m in K3_M:
                    g = torch.randn((m, q_out), generator=gen,
                                    device="cuda").to(dtype)
                    got = fm.fused_decode_matmul_bwd(g, planes, affine,
                                                     None, G, Gp)
                    want = fm.fused_decode_matmul_bwd_ref(g, planes, affine,
                                                          None, G, Gp)
                    torch.cuda.synchronize()
                    ok, err = tm.compare(got, want, bf16_step=True)[:2]
                    ok = ok and bool(torch.all(
                        got.reshape(m, 8, Gp)[:, :, G:] == 0))
                    max_err = max(max_err, err)
                    if not ok:
                        raise AssertionError(
                            f"K3 {name} m={m} {dt} {n_sets} set(s): kernel "
                            f"vs plain twin beyond tolerance (max |diff| "
                            f"{err}) or pad lanes not zero")
                    k_ms = 1e-3 * tm.graph_us(
                        lambda i: fm.fused_decode_matmul_bwd(
                            g, cp[i % len(cp)], affine, None, G, Gp),
                        4 * len(cp))
                    p_ms = 1e-3 * tm.event_us(
                        lambda i: fm.fused_decode_matmul_bwd_ref(
                            g, cp[i % len(cp)], affine, None, G, Gp), 2)
                    lib_ms = 1e-3 * tm.graph_us(lambda i: torch.matmul(
                        g, Wc[i % len(Wc)][0]), 4 * len(Wc))
                    nbytes = nb + m * q_out * esz + m * 8 * Gp * esz
                    peak = tm.BF16_OPS_PER_S if dtype == torch.bfloat16 else \
                        tm.F32_OPS_PER_S
                    b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
                    b_ops = 2 * m * q_out * q_in / peak * 1e3
                    row = {"layer": name, "q_out": q_out, "Gp": Gp, "m": m,
                           "dtype": dt, "sets": n_sets, "max_abs_err": err,
                           "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                           "bound_ms": max(b_bytes, b_ops),
                           "bound_by": "bytes" if b_bytes >= b_ops
                           else "operations", "bytes": nbytes}
                    rows.append(row)
                    log(f"kernel k3 {name:6s} {q_out}x{Gp} m={m:4d} {dt} "
                        f"{n_sets} set(s): max|k-plain| {err:.3g} (tol 1 bf16"
                        f" ulp + 1e-5 max) | kernel {k_ms * 1e3:.1f} us | "
                        f"plain {p_ms * 1e3:.1f} us | bound "
                        f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']},"
                        f" {nbytes / 1e6:.2f} MB) | "
                        f"{row['bound_ms'] / k_ms:.0%} of bound | library "
                        f"{lib_ms * 1e3:.1f} us (g @ W, W dense {dt})")
                del W, Wc
            del cp
            torch.cuda.empty_cache()
    for m in K3_M:
        per = {key: call_sum(rows, K3_CALLS, key, m=m, dtype="bfloat16",
                             sets=1)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"kernel k3 per LoRA step's 222 calls at m={m} (bf16, 1 set): "
            + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    k3_relayout_cost(gen)
    return rows, max_err


def phase_k2_kernels():
    """fused_decode_matmul_tc (K2) against its plain twin at the training
    shapes (K3's: q/k/v/o, gate/up, down, head), with the rows a prefill
    (m = 64) and a LoRA step (m = 1022) give it, in bf16 and f32, with 1
    and 2 plane sets, no scale vector (the training path's linears have
    none). Timed as phase 2 times K1, beside the library product x @ W.T
    with W decoded beforehand in x's dtype (natural order). The bound
    counts the planes, x and out once each, and 2*m*q_out*q_in operations
    at the peak rate of x's dtype. Then, at m = 1022 and 2044 (bf16, 1
    set), the dense route that quant_matmul takes from FUSED_MAX_M rows on
    (decode_weights + torch.matmul) beside K2 at the same m."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, dense, max_err = [], [], 0.0
    for name, q_out, q_in in K3_SHAPES:
        G = q_in // 8
        qt2 = random_qtensor("E8P12RVQ4B", None, q_out, q_in, gen, "cuda")
        for n_sets in (1, 2):
            qt = qt2 if n_sets == 2 else QuantizedTensor(
                {"w0": qt2.planes["w0"]}, "E8P12", q_out, q_in)
            planes, affine, Gp = qt.plane_list(), qt.decode_affine, \
                qt.group_cols
            nb = sum(w.numel() * 4 for w in planes)
            cp = tm.cold_copies(planes)
            for dt in ("bfloat16", "float32"):
                dtype = getattr(torch, dt)
                esz = 2 if dtype == torch.bfloat16 else 4
                W = decode_weights(qt, dtype=dtype)
                Wc = tm.cold_copies([W])
                ms = K2_M + ((DENSE_M[-1],) if n_sets == 1
                             and dtype == torch.bfloat16 else ())
                for m in ms:
                    x = torch.zeros((m, 8, Gp), device="cuda")
                    x[:, :, :G] = torch.randn((m, 8, G), generator=gen,
                                              device="cuda")
                    x = x.reshape(m, 8 * Gp).to(dtype)
                    x_nat = x.reshape(m, 8, Gp)[:, :, :G].transpose(
                        1, 2).reshape(m, q_in).contiguous()
                    got = fm.fused_decode_matmul_tc(x, planes, affine)
                    want = fm.fused_decode_matmul_ref(x, planes, affine)
                    torch.cuda.synchronize()
                    ok, err = tm.compare(got, want, bf16_step=True)[:2]
                    max_err = max(max_err, err)
                    if not ok:
                        raise AssertionError(
                            f"K2 {name} m={m} {dt} {n_sets} set(s): kernel "
                            f"vs plain twin beyond tolerance (max |diff| "
                            f"{err})")
                    k_ms = 1e-3 * tm.graph_us(
                        lambda i: fm.fused_decode_matmul_tc(
                            x, cp[i % len(cp)], affine), 4 * len(cp))
                    p_ms = 1e-3 * tm.event_us(
                        lambda i: fm.fused_decode_matmul_ref(
                            x, cp[i % len(cp)], affine), 2)
                    lib_ms = 1e-3 * tm.graph_us(lambda i: torch.matmul(
                        x_nat, Wc[i % len(Wc)][0].T), 4 * len(Wc))
                    nbytes = nb + m * 8 * Gp * esz + m * q_out * esz
                    peak = tm.BF16_OPS_PER_S if dtype == torch.bfloat16 else \
                        tm.F32_OPS_PER_S
                    b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
                    b_ops = 2 * m * q_out * q_in / peak * 1e3
                    row = {"layer": name, "q_out": q_out, "Gp": Gp, "m": m,
                           "dtype": dt, "sets": n_sets, "max_abs_err": err,
                           "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                           "bound_ms": max(b_bytes, b_ops),
                           "bound_by": "bytes" if b_bytes >= b_ops
                           else "operations", "bytes": nbytes}
                    rows.append(row)
                    log(f"kernel k2 {name:6s} {q_out}x{Gp} m={m:4d} {dt} "
                        f"{n_sets} set(s): max|k-plain| {err:.3g} (tol 1 bf16"
                        f" ulp + 1e-5 max) | kernel {k_ms * 1e3:.1f} us | "
                        f"plain {p_ms * 1e3:.1f} us | bound "
                        f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']},"
                        f" {nbytes / 1e6:.2f} MB) | "
                        f"{row['bound_ms'] / k_ms:.0%} of bound | library "
                        f"{lib_ms * 1e3:.1f} us (x @ W.T, W dense {dt})")
                    if m in DENSE_M and n_sets == 1 and \
                            dtype == torch.bfloat16:
                        d_ms = 1e-3 * tm.graph_us(lambda i: torch.matmul(
                            x_nat, decode_weights(QuantizedTensor(
                                {"w0": cp[i % len(cp)][0]}, "E8P12", q_out,
                                q_in), dtype=dtype).T), 2 * len(cp))
                        dense.append({"layer": name, "m": m, "ms": d_ms,
                                      "k2_ms": k_ms})
                        log(f"kernel k2 {name:6s} m={m}: dense route "
                            f"(decode_weights + torch.matmul) {d_ms * 1e3:.1f}"
                            f" us | K2 {k_ms * 1e3:.1f} us | dense/K2 "
                            f"{d_ms / k_ms:.2f}x")
                    del x, x_nat, got, want
                del W, Wc
            del cp
            torch.cuda.empty_cache()
    for m in K2_M:
        for dt in ("bfloat16", "float32"):
            per = {key: call_sum(rows, K2_CALLS, key, m=m, dtype=dt, sets=1)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"kernel k2 per training forward's 225 calls at m={m} ({dt},"
                f" 1 set): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in per.items()))
    for m in DENSE_M:
        d = call_sum(dense, K2_CALLS, "ms", m=m)
        k = call_sum(dense, K2_CALLS, "k2_ms", m=m)
        log(f"kernel k2 fused/dense crossover at m={m} (bf16, 1 set, 225 "
            f"calls): dense route {d:.3f} ms, K2 {k:.3f} ms, dense/K2 "
            f"{d / k:.2f}x (FUSED_MAX_M 1025 sends {m} rows to "
            f"{'K2' if m < 1025 else 'the dense route'})")
    return rows, max_err


def k3_relayout_cost(gen):
    """The backward of a linear in a copy layout (``quant_matmul_bwd``:
    the planes re-laid to nibble words, K3, dx in the layout's lane
    order) against the same codes in the nibble layout (K3 alone), bf16,
    m = 1022, at each K3 shape; device ms per call by CUDA events (the
    re-layout allocates, so no graph), the transient bytes it allocates,
    and the sums over one LoRA step's 222 calls."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.qtensor import to_nibble
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    m = K3_M[-1]
    rows = []
    for layout, cb in (("u3", "E8P12"), ("bfp", "E8P12"),
                       ("pb", "E8P12RVQ4B"), ("paired", "E8P12RVQ4B")):
        for name, q_out, q_in in K3_SHAPES:
            qt = random_qtensor(cb, layout, q_out, q_in, gen, "cuda")
            qn = to_nibble(qt)
            g = torch.randn((m, q_out), generator=gen,
                            device="cuda").to(torch.bfloat16)
            nib_ms = 1e-3 * tm.event_us(
                lambda i: fm.quant_matmul_bwd(g, qn), 3)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            lay_ms = 1e-3 * tm.event_us(
                lambda i: fm.quant_matmul_bwd(g, qt), 3)
            extra = torch.cuda.max_memory_allocated() - base
            rows.append({"layer": name, "layout": layout, "ms": lay_ms,
                         "nibble_ms": nib_ms})
            log(f"kernel k3 {layout:6s} {name:6s} {q_out}x{q_in} m={m} bf16:"
                f" re-laid + K3 {lay_ms * 1e3:.1f} us | nibble K3 "
                f"{nib_ms * 1e3:.1f} us | transient {extra / 2 ** 20:.1f} "
                f"MiB (dx included)")
            del qt, qn, g
        torch.cuda.empty_cache()
        lay = call_sum(rows, K3_CALLS, "ms", layout=layout)
        nib = call_sum(rows, K3_CALLS, "nibble_ms", layout=layout)
        log(f"kernel k3 {layout} per LoRA step's 222 calls at m={m} (bf16):"
            f" re-laid + K3 {lay:.2f} ms, nibble K3 {nib:.2f} ms, re-layout "
            f"{lay - nib:.2f} ms")


@contextlib.contextmanager
def kernel_events(names):
    """While active, each named kernel wrapper of ops/fused_matmul.py
    records a CUDA event pair around every call; yields {name: [pairs]}.
    A wrapper carries the count of its function while it stands in (the
    function counts under its module-level name)."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    orig = {n: getattr(fm, n) for n in names}
    pairs = {n: [] for n in names}

    def timed(n):
        def call(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = orig[n](*a, **k)
            e1.record()
            pairs[n].append((e0, e1))
            return out
        call.launches = orig[n].launches
        return call
    for n in names:
        setattr(fm, n, timed(n))
    try:
        yield pairs
    finally:
        for n in names:
            orig[n].launches = getattr(fm, n).launches
            setattr(fm, n, orig[n])


def adapter_grads(cfg, model, ids, kw):
    """One forward + backward of the causal LM loss; returns (loss, {name:
    grad}) of the adapters, with host-clock forward and backward ms."""
    import torch
    from quip_for_all_tpu_torch.nn.lora import collect_lora_trainable
    from quip_for_all_tpu_torch.quantize.lora_train import causal_lm_loss
    flat = collect_lora_trainable(model.layers, "layers")
    for p in flat.values():
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = causal_lm_loss(cfg, model, ids, kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return loss.item(), {k: p.grad.clone() for k, p in flat.items()}, (
        (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def epoch_losses(run) -> list:
    """Call ``run`` (a ``train_lora`` without validation) and return the
    loss of each epoch from its "lora epoch N train loss X" log records,
    with the time it took."""
    import logging
    import re
    import torch
    logger = logging.getLogger("quip_for_all_tpu_torch.quantize.lora_train")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    h, level = Keep(), logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    t = time.time()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
    log(f"train: train_lora ran in {time.time() - t:.1f} s")
    return [float(m.group(1)) for m in (
        re.match(r"lora epoch \d+ train loss ([\d.]+)$", r)
        for r in records) if m]


def phase_train():
    """LoRA fine-tuning of Llama-2-7B E8P12 at full width (phase 14)."""
    import gc
    import numpy as np
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.data.calibration import synthetic_tokens
    from quip_for_all_tpu_torch.nn.lora import (add_lora,
                                                collect_lora_trainable)
    from quip_for_all_tpu_torch.quantize.lora_train import train_lora
    from quip_for_all_tpu_torch.runtime import generate as G
    cfg = qt.llama2_7b_config()
    per_fwd = 7 * LAYERS + 1                    # every quantized linear
    per_bwd = per_fwd - 3                       # less layer 0's q/k/v
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    add_lora(model, rank=8, alpha=16.0)
    flat = collect_lora_trainable(model.layers, "layers")
    # B off zero (seeded), so that A takes gradients in the comparisons
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for k, p in flat.items():
            if k.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 1e-3)
    torch.cuda.synchronize()
    log(f"train: built Llama-2-7B E8P12 (random codes, seed 0, unfused, "
        f"quantized head) with rank-8 adapters on {len(flat) // 2} linears "
        f"in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    toks = synthetic_tokens(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0)
    ids = torch.as_tensor(toks, device="cuda")
    rows_per_step = TRAIN_B * (TRAIN_S - 1)

    # every adapter gradient, kernels against the plain route, with the
    # launch counts of the kernel run's forward and backward
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        for impl in ("plain", "auto"):
            reset_launches()
            loss, grads[impl], _ = adapter_grads(
                cfg, model, ids, {"compute_dtype": dt, "matmul_impl": impl})
            launches = read_launches()
            check_launches(f"train [{impl}, {dt}] one step", launches,
                           {} if impl == "plain" else
                           {"fused_decode_matmul_tc": per_fwd,
                            "fused_decode_matmul_bwd": per_bwd})
            log(f"train [{impl}, {dt}]: loss {loss:.6g}")
        keys = sorted(grads["auto"])
        if dt == torch.float32:
            worst = max((float((grads["auto"][k] - grads["plain"][k]).abs()
                               .max() / grads["plain"][k].abs().max()), k)
                        for k in keys)
            log(f"train [f32]: adapter gradients, kernels vs plain route: "
                f"worst max|diff|/max|grad| {worst[0]:.3g} ({worst[1]}; tol "
                f"1e-3) over {len(keys)} tensors")
            if not worst[0] <= 1e-3:
                raise AssertionError(f"train f32 gradients differ: {worst}")
        else:
            a = torch.cat([grads["auto"][k].flatten().float() for k in keys])
            b = torch.cat([grads["plain"][k].flatten().float() for k in keys])
            cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
            per = min(float(torch.nn.functional.cosine_similarity(
                grads["auto"][k].flatten().float(),
                grads["plain"][k].flatten().float(), dim=0)) for k in keys)
            log(f"train [bf16]: adapter gradients, kernels vs plain route: "
                f"cosine of the flattened gradients {cos:.6f} (tol >= 0.99);"
                f" lowest per tensor {per:.4f}")
            if not cos >= 0.99:
                raise AssertionError(f"train bf16 gradient cosine {cos}")
    del grads

    # the step timed (bf16 compute, the default), after one warm-up step;
    # then one step with a CUDA event pair around every K2 and K3 launch
    adapter_grads(cfg, model, ids, {})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, _, (fwd_ms, bwd_ms) = adapter_grads(cfg, model, ids, {})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches("train step (bf16)", launches,
                   {"fused_decode_matmul_tc": per_fwd,
                    "fused_decode_matmul_bwd": per_bwd})
    names = ("fused_decode_matmul_tc", "fused_decode_matmul_bwd")
    with kernel_events(names) as pairs:
        adapter_grads(cfg, model, ids, {})
    torch.cuda.synchronize()
    ev = {n: sum(a.elapsed_time(b) for a, b in pairs[n]) for n in names}
    step_ms = fwd_ms + bwd_ms
    log(f"train step (batch {TRAIN_B} x {TRAIN_S}, {rows_per_step} rows, "
        f"bf16): forward {fwd_ms:.1f} ms + backward {bwd_ms:.1f} ms = "
        f"{step_ms:.1f} ms ({rows_per_step / step_ms * 1e3:.1f} rows/s); "
        f"K2 {ev[names[0]]:.1f} ms over {len(pairs[names[0]])} launches, K3 "
        f"{ev[names[1]]:.1f} ms over {len(pairs[names[1]])} launches (CUDA "
        f"events); peak {peak:.2f} GiB")
    train = {"launches": launches["fused_decode_matmul_bwd"],
             "k2_launches": launches["fused_decode_matmul_tc"],
             "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "k2_ms": ev[names[0]],
             "k3_ms": ev[names[1]], "peak_gib": peak}

    # 8 AdamW steps at the CLI's lr on the one batch (8 epochs of one
    # step), B back at zero (a fresh start); the losses are read from
    # train_lora's per-epoch log lines, and no step may rise
    with torch.no_grad():
        for k, p in flat.items():
            if k.endswith("lora_B"):
                p.zero_()
    hist = epoch_losses(lambda: train_lora(
        cfg, model, toks, rank=8, alpha=16.0, lr=1e-4, epochs=8,
        batch_size=TRAIN_B))
    rises = sum(b > a for a, b in zip(hist, hist[1:]))
    log(f"train: train_lora, 8 AdamW steps (lr 1e-4) on one batch: losses "
        + ", ".join(f"{v:.5f}" for v in hist)
        + f" ({rises} step-to-step rises)")
    if not (len(hist) == 8 and np.all(np.isfinite(hist)) and rises == 0
            and hist[-1] < hist[0]):
        raise AssertionError(f"train: loss did not fall at every step: "
                             f"{hist}")

    # the CLI default batch 4 x 512: 2044 rows, the dense route
    big = torch.as_tensor(synthetic_tokens(4, TRAIN_S, cfg.vocab_size,
                                           seed=1), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, _, (f2, b2) = adapter_grads(cfg, model, big, {})
    check_launches("train step at the CLI default (4 x 512, dense route)",
                   read_launches(), {})
    log(f"train step at the CLI default (4 x {TRAIN_S}, "
        f"{4 * (TRAIN_S - 1)} rows, dense route): forward {f2:.1f} ms + "
        f"backward {b2:.1f} ms; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    train.update(dense_ms=f2 + b2,
                 dense_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del big

    # serving the trained adapters: 225 K1 launches per token, and the f32
    # greedy tokens of the kernels equal the plain route's
    prompt = torch.as_tensor(toks[:1, :32], device="cuda")
    n = 16
    reset_launches()
    ids_b, _, runner = G._generate(cfg, model, prompt, n, cache_len=64)
    check_launches("train: generate with adapters (bf16, graphed)",
                   read_launches(),
                   {"fused_decode_matmul": per_fwd * forwards(runner)})
    outs = {}
    for impl in ("auto", "plain"):
        outs[impl] = G._generate(cfg, model, prompt, n, cache_len=64,
                                 dtype=torch.float32, graphs=False,
                                 linear_kw={"compute_dtype": torch.float32,
                                            "matmul_impl": impl})[0]
    same = bool(torch.equal(outs["auto"], outs["plain"]))
    log(f"train: generate {n} greedy tokens with the trained adapters: "
        f"f32 kernel tokens equal the plain route's: {same}; bf16 tokens "
        f"{ids_b[0, 32:].tolist()}")
    if not same:
        raise AssertionError("train: adapters served through K1 fork from "
                             "the plain route in f32")
    del model, flat
    gc.collect()
    torch.cuda.empty_cache()
    return train


# phase 17: (kernel name, codebook, layout, split-K chunks asked) of every
# kernel that takes right_hb; the right transform's M of each Llama-2-7B
# linear (random_quantized_model's use_rand factors: 4096 = 2^12, 11008 =
# 43 * 256, 32000 = 125 * 256), so B = 128 everywhere
RIGHT_KERNELS = [("fused_decode_matmul", "E8P12", "nibble", 0),
                 ("sw_decode_matmul", "E8P12", "sw4", 0),
                 ("bfp_decode_matmul", "E8P12", "bfp", 0),
                 ("ksplit_decode_matmul", "E8P12", "nibble", 2),
                 ("ksplit_decode_matmul", "E8P12", "nibble", 4),
                 ("paired_decode_matmul", "E8P12RVQ4B", "paired", 0),
                 ("rowpair_pb_decode_matmul", "E8P12RVQ4B", "pb", 0),
                 ("rowpair_u3_decode_matmul", "E8P12", "u3", 0)]
RIGHT_M = {"qkv": 4096, "o": 4096, "gateup": 256, "down": 4096, "head": 256}
RIGHT_CASES = [(1, "bfloat16"), (8, "bfloat16"), (32, "bfloat16"),
               (1, "float32")]
# the combined decode: (m, rows bound n) on K1 (m <= 32) and K2 (above)
COMBINE_CASES = [(1, 8), (8, 8), (40, 8), (64, 32)]


def _right_check(tag, got, plain_k, want, plain_t, hb):
    """A kernel's output with right_hb against the same kernel's without it
    followed by the torch product (one rounding apart: 1 bf16 ulp + 1e-5
    max), and against its plain twin with right_hb, whose tolerance adds
    |Hb| times the kernel-vs-twin difference before the epilogue (a first
    rounding one ulp apart is carried by the product). Returns the max
    |diff| to the twin."""
    import torch
    from quip_for_all_tpu_torch.ops import layout_matmul as lm
    ok, err = tm.compare(got, lm.right_epilogue(plain_k, hb),
                         bf16_step=True)[:2]
    if not ok:
        raise AssertionError(f"{tag}: right epilogue vs the kernel without "
                             f"it + the product beyond tolerance ({err})")
    d = (plain_k.float() - plain_t.float()).abs()
    m, q = d.shape
    B = hb.shape[0]
    carry = (d.reshape(m, q // B, B) @ hb.abs().T).reshape(m, q)
    g, w = got.float(), want.float()
    tol = 1e-5 * w.abs().max() + carry
    if got.dtype == torch.bfloat16:
        a = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
    diff = (g - w).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{tag}: right epilogue vs plain twin beyond "
                             f"tolerance ({float(diff.max())})")
    return float(diff.max())


def phase_right_kernels():
    """(i) every kernel with right_hb, (ii) the combined decode (see the
    module docstring). Returns the rows of (i) and (ii)."""
    import dataclasses
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops import layout_matmul as lm
    from quip_for_all_tpu_torch.transforms.incoherence import right_hb_tensor
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for kname, cb, layout, ks in RIGHT_KERNELS:
        for name, q_out, q_in, with_scale, _ in SHAPES[:5]:
            chunks = (fm.pick_ksplit(ks, -(-(q_in // 8) // 128) * 128) if ks
                      else 1)
            if ks and chunks < 2:
                continue                   # down: K1 (11 lane blocks)
            qt = random_qtensor(cb, layout, q_out, q_in, gen, "cuda")
            qts = [dataclasses.replace(qt, planes=p)
                   for p in tm.cold_copies(qt.planes)]
            hb = right_hb_tensor(RIGHT_M[name], torch.device("cuda"))
            scale = (torch.rand(q_out, generator=gen, device="cuda") + 0.5
                     if with_scale else None)
            for m, dt in RIGHT_CASES:
                dtype = getattr(torch, dt)
                x = fm.grouped_permute(
                    torch.randn((m, q_in), generator=gen, device="cuda"),
                    qt.group_cols, qt.split).to(dtype)

                def run(q, plain, right):
                    return fm._forward(x, q, scale, plain, ks,
                                       right_hb=hb if right else None)
                tag = f"17 i {kname} [{layout} {ks or ''}] {name} m={m} {dt}"
                got = run(qt, False, True)
                err = _right_check(tag, got, run(qt, False, False),
                                   run(qt, True, True), run(qt, True, False),
                                   hb)
                row = {"kernel": kname, "layout": layout, "ks": ks,
                       "chunks": chunks, "layer": name, "m": m, "dtype": dt,
                       "max_abs_err": err}
                if dt == "bfloat16":
                    row["right_ms"] = 1e-3 * tm.graph_us(
                        lambda i: run(qts[i % len(qts)], False, True),
                        4 * len(qts))
                    row["base_ms"] = 1e-3 * tm.graph_us(
                        lambda i: lm.right_epilogue(
                            run(qts[i % len(qts)], False, False), hb),
                        4 * len(qts))
                    log(f"{tag}: max|k-twin| {err:.3g} | with the epilogue "
                        f"{row['right_ms'] * 1e3:.1f} us | without it + the "
                        f"torch B-block product {row['base_ms'] * 1e3:.1f} "
                        f"us")
                rows.append(row)
            del qt, qts
            torch.cuda.empty_cache()
    # K2 (above 32 rows, bf16 and f32) and K3's backward at 1022 rows
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor
    from quip_for_all_tpu_torch.utils.random_quantized import \
        random_e8p_planes
    for name, q_out, q_in, with_scale, _ in SHAPES[:5]:
        qt = QuantizedTensor({"w0": random_e8p_planes(q_out, q_in, gen,
                                                      "cuda")},
                             "E8P12", q_out, q_in)
        qts = [dataclasses.replace(qt, planes=p)
               for p in tm.cold_copies(qt.planes)]
        hb = right_hb_tensor(RIGHT_M[name], torch.device("cuda"))
        for m, dt in ((64, "bfloat16"), (1022, "bfloat16"),
                      (64, "float32")):
            dtype = getattr(torch, dt)
            x = torch.randn((m, 8 * qt.group_cols), generator=gen,
                            device="cuda").to(dtype)

            def run(q, plain, right):
                return fm._forward(x, q, None, plain, 0,
                                   right_hb=hb if right else None)
            tag = f"17 i fused_decode_matmul_tc {name} m={m} {dt}"
            err = _right_check(tag, run(qt, False, True),
                               run(qt, False, False), run(qt, True, True),
                               run(qt, True, False), hb)
            row = {"kernel": "fused_decode_matmul_tc", "layout": "nibble",
                   "layer": name, "m": m, "dtype": dt, "max_abs_err": err}
            if dt == "bfloat16":
                row["right_ms"] = 1e-3 * tm.graph_us(
                    lambda i: run(qts[i % len(qts)], False, True),
                    2 * len(qts))
                row["base_ms"] = 1e-3 * tm.graph_us(
                    lambda i: lm.right_epilogue(
                        run(qts[i % len(qts)], False, False), hb),
                    2 * len(qts))
                log(f"{tag}: max|k-twin| {err:.3g} | with the epilogue "
                    f"{row['right_ms'] * 1e3:.1f} us | without it + the "
                    f"torch B-block product {row['base_ms'] * 1e3:.1f} us")
            rows.append(row)
        # K3 at 1022 rows: g times Hb (f32), then the backward
        g = torch.randn((1022, q_out), generator=gen, device="cuda")
        got = fm.quant_matmul_bwd(g, qt, right_hb=hb)
        want = fm.quant_matmul_bwd(g, qt, plain=True, right_hb=hb)
        torch.cuda.synchronize()
        ok, err = tm.compare(got, want)[:2]
        if not ok:
            raise AssertionError(f"17 i K3 {name}: backward with right_hb vs "
                                 f"plain twin beyond tolerance ({err})")
        r_ms = 1e-3 * tm.graph_us(lambda i: fm.quant_matmul_bwd(
            g, qts[i % len(qts)], right_hb=hb), 2 * len(qts))
        b_ms = 1e-3 * tm.graph_us(lambda i: fm.quant_matmul_bwd(
            g, qts[i % len(qts)]), 2 * len(qts))
        rows.append({"kernel": "fused_decode_matmul_bwd", "layer": name,
                     "m": 1022, "dtype": "float32", "max_abs_err": err,
                     "right_ms": r_ms, "base_ms": b_ms})
        log(f"17 i fused_decode_matmul_bwd {name} m=1022 f32: max|k-twin| "
            f"{err:.3g} | g times Hb + K3 {r_ms * 1e3:.1f} us | K3 alone "
            f"{b_ms * 1e3:.1f} us")
        del qt, qts, g
        torch.cuda.empty_cache()
    # (ii) the combined decode
    for cb in ("E8P12RVQ4B", "E8P12RVQ3B"):
        for name, q_out, q_in, with_scale, _ in SHAPES[:5]:
            if cb == "E8P12RVQ3B" and name not in ("qkv", "down"):
                continue
            for layout in ("nibble", "sw4"):
                qt = random_qtensor(cb, layout, q_out, q_in, gen, "cuda")
                hb = right_hb_tensor(RIGHT_M[name], torch.device("cuda"))
                for m, n in COMBINE_CASES:
                    if layout == "sw4" and m > 32:
                        continue
                    x = fm.grouped_permute(torch.randn(
                        (m, q_in), generator=gen, device="cuda"),
                        qt.group_cols, qt.split).to(torch.bfloat16)
                    tag = (f"17 ii combine {cb} [{layout}] {name} m={m} "
                           f"n={n}")
                    if not fm.combine_applies(qt, max(8, -(-m // 8) * 8), n):
                        raise AssertionError(f"{tag}: does not combine")
                    before = (fm.fused_decode_matmul.launches,
                              fm.fused_decode_matmul_tc.launches,
                              lm.sw_decode_matmul.launches)
                    got = fm._forward(x, qt, None, False, 0, combine=n)
                    after = (fm.fused_decode_matmul.launches,
                             fm.fused_decode_matmul_tc.launches,
                             lm.sw_decode_matmul.launches)
                    want = fm._forward(x, qt, None, True, 0, combine=n)
                    torch.cuda.synchronize()
                    ok, err = tm.compare(got, want, bf16_step=True)[:2]
                    if not ok or sum(after) - sum(before) != 1:
                        raise AssertionError(f"{tag}: vs twin {err}, "
                                             f"launches {before} {after}")
                    gr = fm._forward(x, qt, None, False, 0, right_hb=hb,
                                     combine=n)
                    torch.cuda.synchronize()
                    ok, e2 = tm.compare(gr, lm.right_epilogue(got, hb),
                                        bf16_step=True)[:2]
                    if not ok:
                        raise AssertionError(f"{tag}: with right_hb {e2}")
                    row = {"kernel": "combine", "codebook": cb,
                           "layout": layout, "layer": name, "m": m,
                           "dtype": "bfloat16", "max_abs_err": max(err, e2)}
                    if m == 1 and cb == "E8P12RVQ4B":
                        qts = [dataclasses.replace(qt, planes=p)
                               for p in tm.cold_copies(qt.planes)]
                        row["right_ms"] = 1e-3 * tm.graph_us(
                            lambda i: fm._forward(x, qts[i % len(qts)], None,
                                                  False, 0, combine=n),
                            4 * len(qts))
                        row["base_ms"] = 1e-3 * tm.graph_us(
                            lambda i: fm._forward(x, qts[i % len(qts)], None,
                                                  False, 0), 4 * len(qts))
                        del qts
                    log(f"{tag}: max|k-twin| {err:.3g}, with right_hb "
                        f"{e2:.3g}" + (
                            f" | combined {row['right_ms'] * 1e3:.1f} us, "
                            f"split {row['base_ms'] * 1e3:.1f} us"
                            if "right_ms" in row else ""))
                    rows.append(row)
                del qt
                torch.cuda.empty_cache()
    for kname, _, layout, ks in RIGHT_KERNELS:
        calls = KSPLIT_CALLS if ks else LLAMA_CALLS
        sel = [r for r in rows if r["kernel"] == kname
               and r["layout"] == layout and r.get("ks") == ks]
        for m in (1, 8, 32):
            bf = dict(m=m, dtype="bfloat16")
            log(f"17 i {kname} [{layout} {ks or ''}] per Llama-2-7B "
                f"{'token' if m <= 8 else 'prefill'} at m={m} (bf16): with "
                f"the epilogue {call_sum(sel, calls, 'right_ms', **bf):.3f} "
                f"ms, without it + the torch product "
                f"{call_sum(sel, calls, 'base_ms', **bf):.3f} ms")
    return rows


def right_entries(entries, rows):
    """Each kernel's right-epilogue numbers on its kernels-line entry: per
    Llama-2-7B decode token at m = 1 in bf16 (K2 per 64-row prefill, K3
    per training step's 1022-row calls), with the epilogue (right_ms) and
    without it plus the torch B-block product (right_base_ms); K1's entry
    also the combined decode's per-token time beside the split one."""
    by_name = {e["name"]: e for e in entries}
    for kname, _, layout, ks in RIGHT_KERNELS:
        if kname == "ksplit_decode_matmul" and ks != 4:
            continue
        calls = KSPLIT_CALLS if ks else LLAMA_CALLS
        sel = [r for r in rows if r["kernel"] == kname
               and r["layout"] == layout and r.get("ks") == ks]
        e = by_name[kname]
        e["right_ms"] = call_sum(sel, calls, "right_ms", m=1,
                                 dtype="bfloat16")
        e["right_base_ms"] = call_sum(sel, calls, "base_ms", m=1,
                                      dtype="bfloat16")
        e["right_max_abs_err"] = max(r["max_abs_err"] for r in sel)
    # K2 per 64-row prefill and K3 per 1022-row backward of the main
    # path's (fused) linears, 129 calls
    for kname, m, dt in (("fused_decode_matmul_tc", 64, "bfloat16"),
                         ("fused_decode_matmul_bwd", 1022, "float32")):
        sel = [r for r in rows if r["kernel"] == kname]
        e = by_name[kname]
        e["right_m"] = m
        e["right_ms"] = call_sum(sel, LLAMA_CALLS, "right_ms", m=m, dtype=dt)
        e["right_base_ms"] = call_sum(sel, LLAMA_CALLS, "base_ms", m=m,
                                      dtype=dt)
        e["right_max_abs_err"] = max(r["max_abs_err"] for r in sel)
    comb = [r for r in rows if r["kernel"] == "combine"]
    k1 = by_name["fused_decode_matmul"]
    k1["combine_ms"] = call_sum(comb, LLAMA_CALLS, "right_ms", m=1,
                                layout="nibble", codebook="E8P12RVQ4B")
    k1["combine_split_ms"] = call_sum(comb, LLAMA_CALLS, "base_ms", m=1,
                                      layout="nibble", codebook="E8P12RVQ4B")
    k1["combine_max_abs_err"] = max(r["max_abs_err"] for r in comb)


def phase_right_main(main):
    """(iii) the main path with the right epilogue on (``main``: phase 5's
    model), switched off again at the end."""
    import torch
    import quip_for_all_tpu_torch as qt
    cfg, model, prompt = main["cfg"], main["model"], main["prompt"]
    S, NEW, CACHE = prompt.shape[1], 128, 2048
    per_step = 4 * LAYERS + 1
    _, off8 = f32_logits(cfg, model, prompt, n=8)
    qt.set_right_in_kernel(model, True)
    try:
        _, on8 = f32_logits(cfg, model, prompt, n=8)
        rel = float((on8 - off8).abs().max() / off8.abs().max())
        log(f"17 iii: f32 logits of 8 steps with the epilogue on within "
            f"{rel:.3g} of max|logit| of the switch-off run (tol 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError("17 iii: switch-on f32 logits differ")
        graphed = timed_generate(cfg, model, prompt, CACHE)
        eager = timed_generate(cfg, model, prompt, CACHE, graphs=False)
        graphed(4)
        runs = {}
        for tag, run in (("graphed", graphed), ("eager", eager)):
            reset_launches()
            (ids, logits), t = run(NEW)
            check_launches(f"17 iii {tag}", read_launches(), {
                "fused_decode_matmul": per_step * forwards(run.runner)})
            runs[tag] = (ids, torch.stack(logits), t)
        same = (torch.equal(runs["graphed"][0], runs["eager"][0])
                and torch.equal(runs["graphed"][1], runs["eager"][1]))
        if not same:
            raise AssertionError("17 iii: graphed differs from eager")
        (ids32, lg32), t32 = graphed(32)
        (ids32e, lg32e), _ = eager(32)
        if not (torch.equal(ids32, ids32e)
                and torch.equal(torch.stack(lg32), torch.stack(lg32e))):
            raise AssertionError("17 iii: 32-token graphed run differs")
        dev_on, eager_on = decode_step_device_ms(cfg, model, prompt, CACHE)
        from quip_for_all_tpu_torch.models import llama as M
        from quip_for_all_tpu_torch.runtime.generate import (attn_bucket,
                                                             init_kv_caches)
        caches = init_kv_caches(cfg, 1, CACHE, torch.bfloat16, "cuda")
        M.model_apply(cfg, model, prompt, kv_caches=caches, cache_position=0,
                      dtype=torch.bfloat16,
                      attn_window=attn_bucket(S, CACHE))
        prof = profile_step("decode_step_right", cfg, model, prompt[:, -1:],
                            S, caches, attn_bucket(S + 1, CACHE))
        del caches
    finally:
        qt.set_right_in_kernel(model, False)
    dev_off, eager_off = decode_step_device_ms(cfg, model, prompt, CACHE)
    out = {"ms_tok": runs["graphed"][2] / NEW * 1e3,
           "eager_ms_tok": runs["eager"][2] / NEW * 1e3,
           "ms_tok_32": t32 / 32 * 1e3,
           "dev_ms_on": dev_on, "dev_ms_off": dev_off,
           "eager_step_ms_on": eager_on, "eager_step_ms_off": eager_off,
           "f32_rel_8_steps": rel,
           "right_ms_profiled": prof["by_part_ms"].get(
               "linear: right Hadamard"),
           "right_ops_profiled": prof["by_part_ops"].get(
               "linear: right Hadamard"),
           "profile": prof}
    log(f"17 iii: epilogue on, generate {S} + {NEW}: graphed "
        f"{out['ms_tok']:.2f} ms/token, eager {out['eager_ms_tok']:.2f} "
        f"ms/token, bitwise equal; 32 tokens graphed {out['ms_tok_32']:.2f} "
        f"ms/token; one graphed step's device time {dev_on:.3f} ms on, "
        f"{dev_off:.3f} ms off (same call); eager step {eager_on:.2f} / "
        f"{eager_off:.2f} ms; right transform in the profiled step "
        f"{out['right_ms_profiled']} ms in {out['right_ops_profiled']} ops")
    return out


def right_combine_path(tag, cfg, model, prompt, dev_off):
    """(iv) a full-width E8P12RVQ4B nibble model with both switches on
    (right epilogue, combine 8): 32 greedy tokens graphed, exact K1
    launches, held to its plain twin in bf16 and f32, one graphed step's
    device time; both switched off again."""
    import torch
    import quip_for_all_tpu_torch as qt
    S, NEW, CACHE = prompt.shape[1], 32, 2048
    per_step = 4 * LAYERS + 1
    qt.set_right_in_kernel(model, True)
    qt.set_combine_planes(model, 8)
    try:
        run = timed_generate(cfg, model, prompt, CACHE)
        run(4)
        reset_launches()
        (ids1, logits1), t1 = run(NEW)
        check_launches(tag, read_launches(), {
            "fused_decode_matmul": per_step * forwards(run.runner)})
        (ids2, _), _ = run(NEW)
        check_runs(tag, cfg, ids1, ids2, logits1, NEW)
        for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
            check_plain(cfg, model, prompt, dt, tol, CACHE, tag=tag,
                        per_step={"fused_decode_matmul": per_step})
        dev_on, _ = decode_step_device_ms(cfg, model, prompt, CACHE)
    finally:
        qt.set_right_in_kernel(model, False)
        qt.set_combine_planes(model, 0)
    log(f"{tag}: E8P12RVQ4B nibble, right epilogue + combine 8: "
        f"{t1 / NEW * 1e3:.2f} ms/token over the call; one graphed step's "
        f"device time {dev_on:.3f} ms (both off: {dev_off:.3f} ms)")
    return {"ms_tok": t1 / NEW * 1e3, "dev_ms_on": dev_on,
            "dev_ms_off": dev_off}


def k3_entry(rows, err, train):
    """The kernels line's K3 entry (the tensor-core backward): per LoRA
    training step (222 calls at m = 1022, bf16, 1 plane set, one MMA term),
    launches from the counted step."""
    sel = [r for r in rows if r["m"] == TRAIN_B * (TRAIN_S - 1)
           and r["dtype"] == "bfloat16" and r["sets"] == 1]
    e = dict(next(k for k in KERNELS
                  if k["name"] == "fused_decode_matmul_bwd"),
             launches=train["launches"], max_abs_err=err,
             **{key: call_sum(sel, K3_CALLS, key)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in sel)
                       else "operations"))
    log(f"train: per step K3 takes {e['ms']:.2f} ms by its per-call graph "
        f"times ({train['k3_ms']:.2f} ms by the step's events) of the "
        f"{train['bwd_ms']:.1f} ms backward; bound {e['bound_ms']:.2f} ms "
        f"({e['bound_by']})")
    return e


def k2_entry(rows, err, train):
    """The kernels line's K2 entry: per LoRA training forward (225 calls
    at m = 1022, bf16, 1 plane set), launches from the counted step."""
    sel = [r for r in rows if r["m"] == TRAIN_B * (TRAIN_S - 1)
           and r["dtype"] == "bfloat16" and r["sets"] == 1]
    e = dict(next(k for k in KERNELS
                  if k["name"] == "fused_decode_matmul_tc"),
             launches=train["k2_launches"], max_abs_err=err,
             **{key: call_sum(sel, K2_CALLS, key)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in sel)
                       else "operations"))
    log(f"train: per forward K2 takes {e['ms']:.2f} ms by its per-call graph"
        f" times ({train['k2_ms']:.2f} ms by the step's events) of the "
        f"{train['fwd_ms']:.1f} ms forward; bound {e['bound_ms']:.2f} ms "
        f"({e['bound_by']}); library {e['library_ms']:.2f} ms")
    return e


def serving_path_launches(entries, graphed, serving, mix):
    """The serving path's launches beside each kernel's entry: K1 in the
    graphed generate and the serving decode, K2 in the serving prefill,
    K4 in Mixtral's serving decode."""
    by = {e["name"]: e for e in entries}
    k1 = by["fused_decode_matmul"].setdefault("launches_by_path", {})
    k1.update(llama2_7b_graphed_generate=graphed["k1_launches"],
              llama2_7b_serving=serving["bf16"]["launches"][
                  "fused_decode_matmul"],
              mixtral_8x7b_serving=mix["serving"]["launches"][
                  "fused_decode_matmul"])
    by["fused_decode_matmul_tc"].setdefault("launches_by_path", {}).update(
        llama2_7b_serving_prefill=serving["bf16"]["launches"][
            "fused_decode_matmul_tc"],
        mixtral_8x7b_serving_prefill=mix["serving"]["launches"][
            "fused_decode_matmul_tc"])
    by["moe_decode_matmul"].setdefault("launches_by_path", {}).update(
        mixtral_8x7b_serving=mix["serving"]["launches"]["moe_decode_matmul"])


def family_path_launches(entries, neox, fams):
    """The other families' launches beside K1's and K2's entries: K1 in
    GPT-NeoX-20B's graphed generate and in each family's at published
    widths, K2 in GPT-NeoX-20B's serving prefill; GPT-NeoX-20B's K1 per
    token at m = 1 beside its bound."""
    by = {e["name"]: e for e in entries}
    k1 = by["fused_decode_matmul"]
    k1.setdefault("launches_by_path", {}).update(
        gpt_neox_20b_graphed_generate=neox["launches"],
        gpt_neox_20b_serving=neox["serving"]["launches"][
            "fused_decode_matmul"],
        **{f"{v['arch']}_{src.split('/')[-1]}": v["launches"]
           for src, v in fams.items()})
    k1["gpt_neox_20b_per_token"] = {
        "calls": neox["k1_per_token"], "ms": neox["kernel_ms_token"],
        "bound_ms": neox["kernel_bound_ms_token"],
        "library_ms": neox["kernel_library_ms_token"]}
    by["fused_decode_matmul_tc"].setdefault("launches_by_path", {}).update(
        gpt_neox_20b_serving_prefill=neox["serving"]["launches"][
            "fused_decode_matmul_tc"])


def call_sum(rows, calls, key, **match):
    """Sum of key over the rows of the named layers, each times its calls
    (e.g. per decode token)."""
    return sum(calls[r["layer"]] * r[key] for r in rows
               if r["layer"] in calls
               and all(r.get(f) == v for f, v in match.items()))


def small_m_sums(rows, match, calls=None):
    """A kernel's Llama-2-7B sums beyond decode at m = 1, for the kernels
    line: per token at m = 8 and per 32-token prefill at m = 32 (bf16, the
    rows that ``match``, each layer times its ``calls``: 129 a token, 97
    for split-K)."""
    out = {}
    for key, m in (("per_token_m8", 8), ("per_prefill_m32", 32)):
        out[key] = {k: call_sum(rows, calls or LLAMA_CALLS, k, m=m, **match)
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return out


def moe_sums(moe_rows):
    """The MoE kernel's Mixtral-8x7B sums beyond decode, for the kernels
    line: R = 16 (8 tokens) and R = 62 (a 31-token sparse prefill), w13
    and w2 of each of the 32 layers."""
    calls = {"w13": LAYERS, "w2": LAYERS}
    return {key: {k: call_sum(moe_rows, calls, k, R=R)
                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for key, R in (("per_8_tokens_R16", 16),
                           ("per_31_token_prefill_R62", 62))}


def kernel_entries(rows, max_err, moe_rows, moe_err, llama_launches, mix,
                   rp_rows, rp_err, paths):
    """The kernels line: per decode token of each kernel's own path (K1's
    at Llama-2-7B's shapes, m = 1, the MoE kernel's at Mixtral's
    w13 and w2 with R = 2, the row-pair kernels' at Llama-2-7B's shapes in
    bf16); launches from the paths' counted runs."""
    moe_calls = {"w13": LAYERS, "w2": LAYERS}

    def entry(kernel, rows_, calls, match, launches, err):
        sel = [r for r in rows_ if r["layer"] in calls
               and all(r[f] == v for f, v in match.items())]
        return dict(kernel, launches=launches, max_abs_err=err,
                    ms=call_sum(sel, calls, "ms"),
                    plain_ms=call_sum(sel, calls, "plain_ms"),
                    bound_ms=call_sum(sel, calls, "bound_ms"),
                    bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                             for r in sel) else "operations"),
                    library_ms=call_sum(sel, calls, "library_ms"))
    fused = entry(KERNELS[0], rows, LLAMA_CALLS, {"m": 1, "sets": 1},
                  llama_launches, max_err)
    fused.update(small_m_sums(rows, {"sets": 1}))
    fused["launches_by_path"] = {
        "llama2_7b": llama_launches,
        "mixtral_8x7b": mix["launches"]["fused_decode_matmul"],
        "llama2_7b_rvq4b_nibble": paths["c_rvq4b_nibble"]["launches"]}
    moe = entry(KERNELS[1], moe_rows, moe_calls, {"R": 2},
                mix["launches"]["moe_decode_matmul"], moe_err)
    moe.update(moe_sums(moe_rows))
    moe["mixtral_16_token_sparse_prefill_device_ms"] = mix[
        "sparse_prefill_device_ms"]
    # Mixtral's decode step: its fused calls (GQA qkv, o, head) and its
    # MoE calls, against the graphed step's device time
    mix_fused = call_sum(rows, MIXTRAL_FUSED_CALLS, "ms", m=1, sets=1)
    log(f"mixtral: per decode token the kernels take {mix_fused:.3f} ms "
        f"(fused_decode_matmul) + {moe['ms']:.3f} ms (moe_decode_matmul) of"
        f" {mix['dev_ms']:.3f} ms graphed device time "
        f"({(mix_fused + moe['ms']) / mix['dev_ms']:.0%}); bound "
        f"{call_sum(rows, MIXTRAL_FUSED_CALLS, 'bound_ms', m=1, sets=1):.3f}"
        f" + "
        f"{moe['bound_ms']:.3f} ms")
    entries = [fused, moe]
    for (layout, _, kname), path in zip(ROWPAIR, ("a_u3", "b_pb")):
        e = entry(next(k for k in KERNELS if k["name"] == kname), rp_rows,
                  LLAMA_CALLS, {"kernel": kname, "m": 1, "dtype": "bfloat16"},
                  paths[path]["launches"], rp_err[kname])
        e.update(small_m_sums(rp_rows, {"kernel": kname,
                                        "dtype": "bfloat16"}))
        log(f"{path}: per decode token the {layout} kernel takes "
            f"{e['ms']:.3f} ms of {paths[path]['dev_ms']:.3f} ms graphed "
            f"device time ({e['ms'] / paths[path]['dev_ms']:.0%}); bound "
            f"{e['bound_ms']:.3f} ms")
        entries.append(e)
    return entries


def layout_entries(rows, max_err, paths):
    """The kernels line's K10, K11, K6 and K7 entries: per decode token of
    each kernel's own full-width path (m=1, bf16), launches from its
    counted run."""
    out = []
    for kname, label, calls, path in (
            ("bfp_decode_matmul", "bfp", LLAMA_CALLS, "d_bfp"),
            ("sw_decode_matmul", "sw4", LLAMA_CALLS, "e_sw4"),
            ("ksplit_decode_matmul", "ksplit4", KSPLIT_CALLS, "f_ksplit4"),
            ("paired_decode_matmul", "paired", LLAMA_CALLS, "g_paired")):
        sel = [r for r in rows if r["variant"] == label and r["m"] == 1
               and r["dtype"] == "bfloat16"]
        e = dict(next(k for k in KERNELS if k["name"] == kname),
                 launches=paths[path]["launches"][kname],
                 max_abs_err=max_err[kname],
                 **{key: call_sum(sel, calls, key)
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
                 bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                          for r in sel) else "operations"))
        e.update(small_m_sums(rows, {"variant": label, "dtype": "bfloat16"},
                              calls))
        e["path_prefill_device_ms"] = paths[path]["prefill_device_ms"]
        log(f"{path}: per decode token the {label} kernel takes "
            f"{e['ms']:.3f} ms of {paths[path]['dev_ms']:.3f} ms graphed "
            f"device time ({e['ms'] / paths[path]['dev_ms']:.0%}); bound "
            f"{e['bound_ms']:.3f} ms")
        out.append(e)
    return out


MB_M = (1, 8)


def phase_microbench():
    """T1-T5 through the microbenchmarks' ``run`` entry points, as a user
    runs them (the tools' default shapes and iterations), at m = 1 and 8;
    every count reset just before and read just after. Each record holds
    its variant against its twin (``tools/_timing.compare``: 1 bf16 ulp +
    1e-5 max for bf16 outputs, 1e-5 max for f32 and the row sums) and its
    times; any mismatch, any microbenchmark kernel not launched, or a
    count that the records do not account for fails the phase."""
    from quip_for_all_tpu_torch.tools import microbench_bfp as tb
    from quip_for_all_tpu_torch.tools import microbench_decode as td
    from quip_for_all_tpu_torch.tools import microbench_kernel as tk
    from quip_for_all_tpu_torch.tools import microbench_split as ts
    from quip_for_all_tpu_torch.tools import microbench_tn as tt
    reset_launches()
    recs = []
    for m in MB_M:
        for tool in (tk, td, ts, tt, tb):
            recs += tool.run(m=m)
    launches = read_launches()
    for r in recs:
        key = r["kernel"]
        rpb = (f" rows/block {r['rows_per_block']:3d}"
               if "rows_per_block" in r else "")
        lib = (f"{r['library_us']:.1f} us" if r["library_us"] is not None
               else "none")
        log(f"microbench {r['tool']}:{r['variant']} ({key}) {r['N']}x{r['K']}"
            f" m={r['m']}{rpb}: max|k-plain| {r['max_abs_err']:.3g} (tol "
            f"{r['tol']}) | kernel {r['us']:.2f} us | plain "
            f"{r['plain_us']:.1f} us | bound {r['bound_us']:.2f} us "
            f"({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB) | "
            f"{r['pct_of_bound']:.0f}% of bound, {r['gbps']:.0f} GB/s | "
            f"library {lib} | launches {r['launches']}")
        if r["variant"] == "probe":
            log(f"microbench: bitcast order on the card: interleaved="
                f"{r['interleaved']}, lo_first={r['lo_first']}")
    bad = [(r["tool"], r["variant"], r["N"], r["m"], r["max_abs_err"],
            r.get("error")) for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"microbench: kernel vs plain twin beyond "
                             f"tolerance: {bad}")
    by_counter = {}
    for r in recs:
        by_counter[r["kernel"]] = by_counter.get(r["kernel"], 0) + \
            r["launches"]
    for k, n in launches.items():
        if n != by_counter.get(k, 0):
            raise AssertionError(f"microbench: {k} launched {n} times, the "
                                 f"records account for {by_counter.get(k, 0)}")
    idle = [k for k in launches if k.startswith("mb_") and launches[k] == 0]
    if idle:
        raise AssertionError(f"microbench: kernels not launched: {idle}")
    log("microbench: launches " + ", ".join(
        f"{k} {n}" for k, n in launches.items() if n))
    log_microbench_findings(recs)
    return recs


def log_microbench_findings(recs):
    """The ablations side by side: the load floors against the decode
    bodies, the rows-per-block curve, bfp against base."""
    def us(tool, variant, m, **match):
        return [r["us"] for r in recs if r["tool"] == tool
                and r["variant"] == variant and r["m"] == m
                and all(r.get(f) == v for f, v in match.items())]
    for m in MB_M:
        t1 = {v: us("microbench_kernel", v, m)[0]
              for v in ("prod", "nodec", "onedot", "stream")}
        log(f"microbench T1 m={m}: " + ", ".join(
            f"{v} {t:.2f} us" for v, t in t1.items())
            + f" -> prod/stream {t1['prod'] / t1['stream']:.2f}x")
        for r in [r for r in recs if r["tool"] == "microbench_tn"
                  and r["m"] == m and r["variant"] == "nib"]:
            dma = us("microbench_tn", "dma", m, N=r["N"], K=r["K"],
                     rows_per_block=r["rows_per_block"])[0]
            log(f"microbench T4 m={m} {r['N']}x{r['K']} rows/block "
                f"{r['rows_per_block']:3d}: nib {r['us']:.2f} us "
                f"({r['pct_of_bound']:.0f}% of bound), dma {dma:.2f} us, "
                f"nib/dma {r['us'] / dma:.2f}x")
        for r in [r for r in recs if r["tool"] == "microbench_bfp"
                  and r["m"] == m and r["variant"] == "bfp"]:
            base = us("microbench_bfp", "base", m, N=r["N"])[0]
            log(f"microbench T5 m={m} {r['N']}x{r['K']}: bfp {r['us']:.2f} "
                f"us, base {base:.2f} us, bfp/base {r['us'] / base:.2f}x")


def microbench_entries(recs):
    """The kernels line's T1-T5 entries, one per variant: its numbers at
    the tool's first default shape and m = 8 (T4: 12288x4096 at 16 rows a
    block, K1's), its launches from the whole phase 15 run."""
    out, seen = [], {}
    for r in recs:
        key = (r["tool"], r["variant"])
        seen.setdefault(key, []).append(r)
    for (tool, variant), rs in seen.items():
        first = rs[0]
        sel = next(r for r in rs if r["m"] == 8 and r["N"] == first["N"]
                   and r["K"] == first["K"]
                   and r.get("rows_per_block", 16) == 16) \
            if variant != "probe" else first
        out.append({"name": f"{tool}:{variant}", "route": "cuda",
                    "source": sel["source"], "replaces": sel["replaces"],
                    "launches": sum(r["launches"] for r in rs),
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": sel["us"] * 1e-3, "plain_ms": sel["plain_us"] * 1e-3,
                    "bound_ms": sel["bound_us"] * 1e-3,
                    "bound_by": sel["bound_by"],
                    "library_ms": (sel["library_us"] * 1e-3
                                   if sel["library_us"] is not None
                                   else None),
                    "shape": f"{sel['N']}x{sel['K']}", "m": sel["m"]})
    return out


def phase_quantize():
    """Phase 19, quantization on the card: (i) Llama-2-7B widths at
    QUANT_LAYERS layers, quantized from a dense model and decoded through
    K1 after save and load; (v) one LDLQ step's cost; (ii) one layer on
    the card against the CPU; (iii) the block and end-to-end finetune at
    full width; (iv) the CLI."""
    import dataclasses
    import gc
    import shutil
    import numpy as np
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.data.calibration import synthetic_tokens
    cfg = dataclasses.replace(qt.llama2_7b_config(),
                              num_hidden_layers=QUANT_LAYERS)
    L = QUANT_LAYERS
    out_dir = os.path.join(REPO, "build", "quantized_7b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.init_llama_params(cfg, seed=0, device="cuda")
    calib = synthetic_tokens(QUANT_ROWS, QUANT_SEQ, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    log(f"quant (i): dense Llama-2-7B widths ({L} layers, f32) and "
        f"{QUANT_ROWS} x {QUANT_SEQ} synthetic calibration tokens made in "
        f"{time.time() - t:.1f} s")
    window = torch.as_tensor(calib[:1], device="cuda")
    f32 = {"compute_dtype": torch.float32}
    with torch.no_grad():
        float_logits = qt.get_arch(cfg).model_apply(cfg, model, window)[0]
    q = qt.QuipQuantizer(codebook="E8P12", quip_tune_iters=10,
                         quantize_lm_head=True, nsamples=QUANT_ROWS,
                         model_seqlen=QUANT_SEQ, batch_size=4)
    torch.cuda.synchronize()
    t = time.time()
    model = q.quantize_model(cfg, model, calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t
    for st in q.layer_stats_:
        log(f"quant (i): {st['linear']}: {st['seconds']:.2f} s, proxy loss "
            f"{st['proxy_loss']:.5f}")
    per_layer = [sum(st["seconds"] for st in q.layer_stats_
                     if st["linear"].startswith(f"layers.{i}."))
                 for i in range(L)]
    head_s = sum(st["seconds"] for st in q.layer_stats_
                 if st["linear"] == "lm_head")
    log(f"quant (i): quantize_model {t_quant:.1f} s: per layer's linears "
        + ", ".join(f"{s_:.1f}" for s_ in per_layer)
        + f" s, head {head_s:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    shutil.rmtree(out_dir, ignore_errors=True)
    t = time.time()
    qt.save_quantized(cfg, model, q.to_dict(), out_dir)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg2, model, _ = qt.load_quantized(out_dir, device="cuda")
    model = qt.fuse_for_inference(cfg2, model)
    torch.cuda.synchronize()
    log(f"quant (i): save_quantized, load_quantized on the card and "
        f"fuse_for_inference in {time.time() - t:.1f} s")
    if cfg2 != cfg:
        raise AssertionError("quant (i): the saved config reads back "
                             "otherwise")
    with torch.no_grad():
        q_logits = qt.get_arch(cfg).model_apply(cfg, model, window,
                                                linear_kw=f32)[0]
    rel = float(torch.linalg.norm(q_logits - float_logits)
                / torch.linalg.norm(float_logits))
    top1 = float((q_logits.argmax(-1) == float_logits.argmax(-1)
                  ).float().mean())
    log(f"quant (i): f32 logits of the quantized model on a calibration "
        f"window of {QUANT_SEQ} tokens against the float model's: relative "
        f"error {rel:.4f} (Frobenius), top-1 agreement {top1:.3f}")
    if not (math.isfinite(rel) and rel < 1.0):
        raise AssertionError(f"quant (i): logits relative error {rel}")
    del float_logits, q_logits
    k1, dense = widths_rule(model)
    if (k1, dense) != (4 * L + 1, 0):
        raise AssertionError(f"quant (i): {k1} K1 linears and {dense} dense "
                             f"ones, expected {4 * L + 1} and 0")
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(0))
    launches, ms_tok, _ = graphed_vs_eager("quant (i)", cfg, model, prompt,
                                           32, 2048, k1)
    check_plain(cfg, model, prompt, torch.float32, 1e-3, 2048, n=8,
                tag="quant (i)", per_step={"fused_decode_matmul": k1})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"layers": L, "seconds": t_quant, "per_layer_s": per_layer,
           "head_s": head_s, "linears": q.layer_stats_,
           "logits_rel_err": rel, "top1": top1,
           "launches": launches["fused_decode_matmul"],
           "k1_per_token": k1, "ms_tok": ms_tok}
    out["step"] = quant_step_profile()
    out["cross_device"] = quant_cross_device()
    out["finetune"] = quant_finetune()
    out["cli"] = quant_cli()
    return out


def quant_step_profile():
    """(v) What one LDLQ step of a 4096-row linear (q, k, v or o; E8P12)
    costs on the card: the rounding alone (scores over the 65536-word
    grid and their argmax) by CUDA-graph replays, with the norms in the
    product's epilogue (``torch.addmm``, the card's route) beside the CPU
    route's two passes (``matmul``, then the subtraction), against its
    bound (the f32 scores written once and read once at 3.35 TB/s); then
    64 sweep steps (4096 x 512) by the host clock and under
    ``torch.profiler``, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from quip_for_all_tpu_torch.codebooks import base, get_codebook
    from quip_for_all_tpu_torch.quantize import ldlq
    cb = get_codebook("E8P12")
    g, gn = base.grid_tensors(cb.grid, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    X2 = 2.0 * torch.randn(4096, 8, device="cuda", generator=gen)
    with ldlq.full_f32():
        fused = tm.graph_us(lambda _: torch.max(torch.addmm(
            -gn, X2, g.T), dim=1), 4, reps=5)
        two = tm.graph_us(lambda _: torch.max(torch.matmul(
            X2, g.T).sub_(gn), dim=1), 4, reps=5)
        bound = 2 * 4096 * 65536 * 4 / tm.HBM_BYTES_PER_S * 1e6
        W = torch.randn(4096, 512, device="cuda", generator=gen)
        A = torch.randn(2048, 512, device="cuda", generator=gen)
        H = A.T @ A / 2048 + 0.01 * torch.eye(512, device="cuda")
        L = torch.linalg.cholesky(H.double()).float()
        ldlq.ldlq(W, H, L, cb, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ldlq.ldlq(W, H, L, cb, 0)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3 / 64
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ldlq.ldlq(W, H, L, cb, 0)
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # the kernels themselves (an aten op's entry repeats its kernels'
        # time)
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 64, ev.count / 64, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    log(f"quant (v): the rounding of one LDLQ step at 4096 rows: addmm + max "
        f"{fused / 1e3:.3f} ms, matmul + sub + max {two / 1e3:.3f} ms "
        f"(CUDA-graph replays), bound {bound / 1e3:.3f} ms (scores written "
        f"and read once); a sweep step {host_ms:.3f} ms by the host clock, "
        f"{dev_ms:.3f} ms of device time (profiler) -> device idle "
        f"{1 - dev_ms / host_ms:.0%}; by kernel per step: " + "; ".join(
            f"{k[:60]} x{c:g} {us:.1f} us" for us, c, k in rows[:6]))
    return {"rounding_addmm_ms": fused / 1e3, "rounding_two_pass_ms":
            two / 1e3, "rounding_bound_ms": bound / 1e3,
            "step_host_ms": host_ms, "step_device_ms": dev_ms}


def quant_cross_device():
    """(ii) One 512 x 1024 layer quantized on the card and on the CPU from
    the same seed: the codes' agreement and both proxy losses (within 2%),
    TF32 off inside the call."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.codebooks import get_codebook
    from quip_for_all_tpu_torch.quantize import quip
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4096, 1024)).astype(np.float32)
    X *= rng.uniform(0.2, 2.0, 1024).astype(np.float32)
    H = (X.T @ X / X.shape[0]).astype(np.float32)
    W = (rng.standard_normal((512, 1024)) / 32.0).astype(np.float32)
    cb = get_codebook("E8P12")
    seen = set()
    orig = type(cb).quantize

    def spy(self, x, chunk=None):
        seen.add((torch.backends.cuda.matmul.allow_tf32,
                  torch.get_float32_matmul_precision()))
        return orig(self, x, chunk)
    type(cb).quantize = spy
    res = {}
    try:
        for dev in ("cuda", "cpu"):
            t = time.time()
            attrs, W_hat = quip.quantize_layer(
                W, H, cb, quip.QuantConfig(quip_tune_iters=2),
                np.random.default_rng(3), device=dev)
            res[dev] = (attrs, quip.proxy_loss(
                torch.from_numpy(W), W_hat.cpu(), torch.from_numpy(H)),
                time.time() - t)
    finally:
        type(cb).quantize = orig
    (ga, gp, gt), (ca, cp, ct) = res["cuda"], res["cpu"]
    agree = float(np.mean(ga.Qidxs_raw == ca.Qidxs_raw))
    log(f"quant (ii): 512 x 1024 E8P12 layer, 2 tune iterations: card "
        f"{gt:.2f} s, proxy loss {gp:.6f}; CPU {ct:.2f} s, proxy loss "
        f"{cp:.6f}; codes agree {agree:.4f}; matmul settings inside the "
        f"calls {sorted(seen)}")
    if seen != {(False, "highest")} or abs(gp - cp) > 0.02 * cp:
        raise AssertionError("quant (ii): TF32 on inside the call, or the "
                             "card's proxy loss off the CPU's by > 2%")
    return {"codes_agree": agree, "proxy_card": gp, "proxy_cpu": cp}


def quant_finetune():
    """(iii) One Llama-2-7B-width layer quantized with no tune iterations,
    then the block finetune between its groups and the end-to-end one,
    both on the card, 2 epochs over small sets: finite losses, none worse
    than its initial one."""
    import dataclasses
    import gc
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.data.calibration import synthetic_tokens
    cfg = dataclasses.replace(qt.llama2_7b_config(), num_hidden_layers=1)
    model = qt.init_llama_params(cfg, seed=1, device="cuda")
    q = qt.QuipQuantizer(codebook="E8P12", quip_tune_iters=0, nsamples=8,
                         batch_size=2, ft_epochs=2, ft_train_size=4,
                         ft_valid_size=2)
    calib = synthetic_tokens(14, 256, cfg.vocab_size, seed=1)
    t = time.time()
    q.quantize_model(cfg, model, calib)
    torch.cuda.synchronize()
    stats = q.ft_block_stats_ + [q.e2e_ft_stats_]
    log(f"quant (iii): 1 full-width layer, block finetune after 3 of 4 "
        f"groups and the end-to-end finetune, 2 epochs, in "
        f"{time.time() - t:.1f} s: validation losses (initial -> best) "
        + "; ".join(f"{s_['initial']:.6g} -> {s_['best']:.6g}"
                    for s_ in stats))
    ok = len(stats) == 4 and all(
        math.isfinite(s_["initial"]) and math.isfinite(s_["best"])
        and s_["best"] <= s_["initial"] for s_ in stats)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"quant (iii): finetune losses {stats}")
    return stats


def quant_cli():
    """(iv) ``cli.quantize --model-path random:tiny --device cuda``, its
    save loaded on the card and run."""
    import shutil
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.cli import quantize
    d = os.path.join(REPO, "build", "quantized_tiny_cli")
    shutil.rmtree(d, ignore_errors=True)
    t = time.time()
    quantize.main(["--model-path", "random:tiny", "--save-dir", d,
                   "--nsamples", "16", "--seqlen", "64",
                   "--quip-tune-iters", "2", "--device", "cuda"])
    cfg, model, qcfg = qt.load_quantized(d, device="cuda")
    ids = qt.generate(cfg, qt.fuse_for_inference(cfg, model),
                      torch.arange(8, device="cuda")[None], 8,
                      cache_len=64, dtype=torch.float32)
    log(f"quant (iv): cli.quantize --model-path random:tiny --device cuda "
        f"wrote {sorted(os.listdir(d))} in {time.time() - t:.1f} s; "
        f"loaded on the card ({qcfg['codebook']}), 8 greedy tokens "
        f"{ids[0, 8:].tolist()}")
    if ids.shape != (1, 16):
        raise AssertionError("quant (iv): generate after the CLI failed")
    return {"seconds": time.time() - t}


def quant_path_launches(entries, quant):
    """K1's launches in phase 19's graphed generate of the model quantized
    on the card."""
    by = {e["name"]: e for e in entries}
    by["fused_decode_matmul"].setdefault("launches_by_path", {}).update(
        {f"llama2_7b_quantized_{quant['layers']}_layers": quant["launches"]})


def at(phase, fn, *args):
    """Run one phase, logging when it starts and how long it took, so the
    script's time against its limit can be read phase by phase."""
    t = time.time()
    log(f"phase {phase}: starts at {t - T0:.1f} s")
    out = fn(*args)
    log(f"phase {phase}: took {time.time() - t:.1f} s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "quip_for_all_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "quip_for_all_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    global tm
    from quip_for_all_tpu_torch.tools import _timing as tm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = smi_line()
        log(f"card: {smi} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        phase_build()
        log("kernels: " + ", ".join(
            f"{k['name']} ({k['route']}, {k['source']}, replaces "
            f"{k['replaces']})" for k in KERNELS))
        rows, max_err = at("2", phase_kernels)
        moe_rows, moe_err = at("3", phase_moe_kernels)
        rp_rows, rp_err = at("7", phase_rowpair_kernels)
        lay_rows, lay_err = at("10", phase_layout_kernels)
        k3_rows, k3_err = at("13", phase_k3_kernels)
        k2_rows, k2_err = at("16", phase_k2_kernels)
        mb_recs = at("15", phase_microbench)
        right_rows = at("17 (i, ii)", phase_right_kernels)
        at("4, 8, 11, 17 (v)", phase_golden, (
            ("e8p12", None), ("e8p12", "u3"), ("e8p12rvq4b", None),
            ("e8p12rvq4b", "pb"), ("e8p12", "bfp"), ("e8p12", "sw2"),
            ("e8p12", "sw4"), ("e8p12rvq4b", "paired"),
            ("e8p12rvq4b", "bfp"), ("d4", None), ("hi", None),
            ("e8p12rvq3b", None), ("d4", None, True), ("hi", None, True),
            ("e8p12rvq3b", None, True), ("e8p12", None, True)))
        launches, main = at("5", phase_main)
        graphed = at("5a", phase_graphed, main)
        serving = at("5b", phase_serving, main)
        profile = at("5e", phase_profile, main)
        at("5d", phase_cli)
        right_main = at("17 (iii)", phase_right_main, main)
        new_paths = at("12", phase_layout_paths, main)
        mix = at("6", phase_mixtral)
        neox = at("18 (i)", phase_neox20b)
        fams = at("18 (ii)", phase_families)
        paths = at("9", phase_rowpair_paths)
        train = at("14", phase_train)
        quant = at("19", phase_quantize)
        entries = kernel_entries(rows, max_err, moe_rows, moe_err, launches,
                                 mix, rp_rows, rp_err, paths)
        entries += layout_entries(lay_rows, lay_err, new_paths)
        entries.append(k3_entry(k3_rows, k3_err, train))
        entries.append(k2_entry(k2_rows, k2_err, train))
        entries += microbench_entries(mb_recs)
        right_entries(entries, right_rows)
        serving_path_launches(entries, graphed, serving, mix)
        family_path_launches(entries, neox, fams)
        quant_path_launches(entries, quant)
        log("right epilogue and combined decode: " + json.dumps({
            "main_path": right_main,
            "rvq4b_nibble_both": paths["c_rvq4b_nibble"]["right_combine"]}))
        log("families: " + json.dumps({"gpt_neox_20b": neox,
                                        "published_widths": fams}))
        log("quantization: " + json.dumps(quant))
        log("serving path: " + json.dumps({
            "graphed_generate": graphed, "decode_step_profile": profile,
            "serving": serving, "mixtral_serving": mix["serving"],
            "mixtral_serving_warm": mix["serving_warm"]}))
        log(f"chip_smoke: wall time {time.time() - T0:.1f} s (limit 1200 s)")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"card: {smi_line()}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
