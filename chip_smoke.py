#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (quip_for_all_tpu_torch) on one CUDA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 21 [--profile-ft]   # one phase alone
    python3 chip_smoke.py --phase 22
    python3 chip_smoke.py --phase 23
    python3 chip_smoke.py --phase 24
    python3 chip_smoke.py --phase 25

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
  6. the Mixtral path: Mixtral-8x7B E8P12 at full width, 8 layers
     (MIXTRAL_LAYERS: 16 since phase 21 came, 8 since phase 22; random codes,
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
  9. the byte-cut paths at full width, 8 layers (PATH9_LAYERS: 16 since
     phase 20 came, 8 since phase 21's sp and pp), random codes from seed 0: (a) Llama-2-7B E8P12 in u3 and (b) E8P12RVQ4B in pb through
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
 12. the new paths at full width, 8 layers (PATH12_LAYERS: 16 since
     phase 21 came, 8 since its sp and pp), right after phase 5 on its
     model cut to its first PATH12_LAYERS blocks: (f) split-K = 4 on the main path's planes, (e) those planes
     re-laid as sw4 and (d) as bfp, each first held to the cut model's
     f32 logits through K1, then (g) E8P12RVQ4B paired from seed 0; each
     as in phase
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
     GPT-NeoX-20B (the published EleutherAI/gpt-neox-20b widths, 22 of
     its 44 layers since phase 23 came, NEOX_LAYERS; E8P12 nibble, random
     codes from seed 0, quantized head: 89 K1 a forward, no dense-route
     linear): K1 launches and dense-route
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
     the widths rule (4 QUANT_LAYERS + 1 K1 a forward), graphed ``generate`` of 32 tokens
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
 20. LoRA on the families at full width, as phase 14 does it: (i)
     Mixtral-8x7B E8P12 (16 of its 32 layers since phase 21 grew, 8
     since phase 22, LORA_MIX_LAYERS; experts stacked, attention unfused, quantized head;
     rank-8 adapters on q/k/v/o) at batch 1 x 512 (511 rows: K2 forward,
     K3 backward, the dense expert loop over the stacked experts' views),
     (ii) GPT-NeoX-20B E8P12 (22 of its 44 layers, 11 since phase 25,
     LORA_NEOX_LAYERS;
     adapters on every block linear) at 2 x 512: each with every adapter
     gradient against the plain route in f32 and bf16 (Mixtral's on its
     first 4 layers), exact K2/K3 launches per step, the step timed with
     K2/K3 event times and its peak memory, 8 AdamW steps of
     ``train_lora`` whose loss falls at every step, and 16 greedy tokens
     with the trained adapters, graphed bitwise the eager loop with exact
     launches and in f32 equal to the plain route's; (iii)
     ``cli.finetune_lora --device cuda --targets ...`` on a 2-layer
     GPT-NeoX checkpoint at 20B widths written by ``save_quantized``, its
     adapters loaded back with ``load_lora`` and ``import_peft`` giving
     the trained model's logits. Phases 13 and 16 time K3 and K2 at (i)'s
     and (ii)'s shapes and rows too.
 21. tensor parallelism on the one card: Llama-2-7B E8P12 nibble at full
     width and depth (random codes from seed 0, fused qkv and gate/up,
     quantized head) with block-diagonal transforms of 2 shards on every
     column-parallel linear's right side and every row-parallel one's
     left (``tp_block_diagonal``, as a ``tp_shards = 2`` checkpoint has
     them), first whole in this process (the one-rank references), then
     as two ranks spawned on ``cuda:0`` over gloo, each holding its half
     of the planes from ``parallel/sharding.py`` ``shard_params``: K1 at
     m = 1 and 8 and K2 at m = 64 against their twin on each rank-local
     shape; f32 logits of a 32-token prefill and 8 cached steps against
     the one-rank model's (1e-4 of max|logit| plus one ulp); 32 greedy
     bf16 tokens, equal on both ranks, that leave the one-rank run's
     only at a near-tie (the one-rank model's top logit at most one bf16
     step above the ranks' token there); ``ServingEngine(mesh=)`` on 4 requests at 4 slots in f32
     (prompts 16-200, 16 new, prefill chunk 128: K2), each request's ids
     equal to the one-rank engine's; exact K1/K2 launches a forward (129)
     and the collectives a token; an eager step with and without its
     collectives. Then, on each rank's whole model (the references in
     this process first, with K2 and K3 timed at the new rows on block
     0's and the head's planes): sequence parallelism, two 2048-token
     windows (1024 rows a rank: K2) through ``perplexity(sp_mesh=)`` in
     f32, window 0's logits through ``sequence_parallel_logits`` against
     the one-rank forward (2048 rows: the dense route), the perplexities
     equal; the pipeline, ``pipeline_logits`` of 2 x 512 ids in 2
     microbatches over 2 stages of 16 layers (512 rows: K2); one
     pipelined end-to-end finetune step as ``QuipQuantizer(ft_pp=2)``
     runs it (the training forward: no kernel) and the same step through
     the eval linears (K2 forward, K3 backward), loss and every gradient
     against the one-rank step's; exact launches, the collectives and
     their host seconds, host times, peak memory, the free device memory
     before and the allocator's retries of each (``--phase 21
     --profile-ft``: the quantizer's step under ``torch.profiler`` too).
     Two ranks on one card measure correctness, launches and
     collectives, not parallel speed.
 22. expert parallelism on the one card: Mixtral-8x7B E8P12 nibble at
     full width, 8 layers (MIXTRAL_EP_LAYERS; random codes from seed 0,
     experts stacked, fused qkv, quantized head, whole transforms), first
     whole in this process (the one-rank references: an f32 prefill of
     32 tokens and 8 cached steps, 16 greedy bf16 tokens through graphed
     ``generate``, ``ServingEngine`` on phase 21's 4 requests in f32),
     with K4 at a rank's dense-stacked shapes (4 experts, R = 4 m, m = 1,
     32, 1024) held to its twin and timed beside its bound, its twin and
     ``torch.bmm`` on the decoded weights; then four gloo ranks spawned on
     ``cuda:0``, each joining through ``parallel/multihost.py``
     ``initialize`` from torchrun's variables, laid out by
     ``make_hybrid_mesh(dcn_dp=1, ici_tp=2, ici_ep=2)``, each holding 4
     experts whole and half of the heads (``shard_params``): K4 against
     its twin at m = 1 and 32 on the rank's experts, then the same three
     runs with every launch and collective count set to 0 before each:
     f32 logits against the one-rank model's (1e-4 of max|logit| plus one
     ulp), served ids equal, greedy ids equal on the four ranks and
     leaving the one-rank run's only at a near-tie (as in phase 21),
     exact K1/K2/K4 launches (every MoE block on the
     dense-stacked route) and the collectives a token. Four ranks on one
     card measure correctness, launches and collectives, not speed.
 23. training under a ("dp", "tp") mesh on the one card: Llama-2-7B
     E8P12 nibble at full width, 8 layers (PHASE23_LAYERS; random codes
     from seed 0, q/k/v/o/gate/up/down unfused, quantized head, phase
     21's tp_shards = 2 transforms), first whole in this process (the
     one-rank references in f32): (a) one end-to-end finetune step
     (``finetune.make_train_step``: the training forward, calc_weight's
     dense W, no kernel; SU/SV, dense weights and norms, two-LR Adam) on
     4 x 512 ids, (b) one LoRA step (rank 8, the default targets, B off
     zero, AdamW at 1e-4) on 2 x 512 ids, 1022 rows: K2 forward, K3
     backward; then four gloo ranks spawned on ``cuda:0`` at
     ``make_mesh(dp=2, tp=2)`` with ``shard_params``: (a) with each dp
     rank its half (``make_train_step(mesh=)``), (b) with the adapters
     added after ``shard_params`` (the bases cut, A and B whole), each
     rank's loss equal to the others' and to the one-rank step's, every
     gradient gathered into the JAX package's names within 1e-4 of its
     max|grad|, the leaves after the step too where |grad| exceeds that;
     K2 and K3 against their twins at each rank-local shape of (b),
     after the steps on every rank and on the even ranks before them too
     (the odd ranks' first comparison comes after gloo's steps, as every
     rank's did when the phase's first run failed there in
     ``torch.exp2``, which the comparison no longer calls; the odd ranks
     log a ``torch.exp2`` probe there, which does not fail the phase;
     timed on rank 0, the others waiting); exact launches a step (none
     in (a); 57 K2 + 54 K3 in (b)), the collectives a step by kind with
     their host seconds, the peak memory a rank. Four ranks on one card
     measure correctness, launches and collectives, not parallel speed.
 24. the tools (``utils/sanitize.py``, ``tools/sanitize.py``,
     ``tools/quality_matrix.py``): (i) the sanitizer on the main path's
     model (phase 5's, reused): determinism over 3 runs of the eager
     bf16 decode step (bf16 caches) and of the graphed step, purity of
     the parameters, ids and positions, finite logits, and variant parity
     at m = 1 and 8 on
     layer 0's qkv, o, gate/up and down and on the head, each through K1
     against ksplit = 2 (K6) and the dense decode, with the function each
     run reached and its max |diff|, and exact K1 launches; (ii) the
     sanitize CLI, ``--model mixtral_8x7b --layers 1`` (in this process,
     its launches counted): Mixtral-8x7B at full width, one layer (seed
     0, experts stacked), its bf16 decode step's checks and its sweep,
     the stacked w13 through K4 against each expert's dense decode;
     (iii) ``python -m
     quip_for_all_tpu_torch.tools.sanitize --model tiny`` as a subprocess
     (exit 0); (iv) ``quality_matrix --fast`` into a temporary directory:
     the E8P12 cell's held-out and train-window ppl within 3% of the
     port's own fp32 model's, that model's held-out ppl within 10% of the
     JAX run's (``docs/QUALITY.json``), and eval_ppl once more in this
     process on the cell's checkpoint (the same ppl, K2 launches counted).
     ``--phase 24`` alone builds the main path's model first.
 25. training over the expert axis on the one card, phase 23's harness
     with phase 22's layout: Mixtral-8x7B E8P12 nibble at full width, 4
     layers (MIXTRAL_TRAIN_LAYERS; random codes from seed 0, experts
     stacked, attention unfused, whole transforms, quantized head), first
     whole in this process (the one-rank references in f32): (a) one
     end-to-end finetune step on 2 x 512 ids and the first 2 blocks
     (MIXTRAL_FT_LAYERS: four ranks' dense f32 expert W at 4 layers did
     not fit on the card; the training forward: the dense expert loop on
     calc_weight's W, no kernel), (b) one LoRA step
     (rank 8 on q/k/v/o, B off zero, AdamW at 1e-4) on 1 x 512 ids, 511
     rows: K2 forward and K3 backward on every quantized linear, the
     expert loop over all 8 experts; then four gloo ranks spawned on
     ``cuda:0`` at ``make_mesh(ep=2, tp=2)`` with ``shard_params`` (4
     experts whole a rank, half of the heads; a forward that autograd
     differentiates takes the dense loop over the rank's own experts,
     ``parallel/layers.py`` ``ExpertParallelMoE``), held as in phase 23:
     losses equal on the ranks and to the one-rank step's, every gradient
     and updated leaf; K2 and K3 against their twins at each rank-local
     shape (q, k, v, o cut, w1/w3 4096 -> 14336, w2 14336 -> 4096, the
     head), timed on rank 0 beside bound, twin and library; exact
     launches (none in (a); one rank 113 K2 + 110 K3 in (b), a rank 65 +
     62), the collectives by kind with their host seconds, the peak
     memory a rank.
Phases run in the order 1-4, 7, 10, 13, 16, 15, 17 (i, ii), 11, 5 (with
a, b, e, d), 17 (iii), 24 (while phase 5's model is whole), 12, 6 (with
c), 18, 9 (with 17 iv), 14, 20, 19, 21, 22, 23, 25;
each logs its start and its seconds. The last
stdout line
is {"ok": true, "device": {...}}; the line before it lists the kernels
with their numbers; the line before that the card's name and power limit.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Callable

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
# phase 9's byte-cut paths run Llama-2-7B at this depth (the only cut):
# the script's time grew by phase 20 (16 layers) and phase 21 (8), and
# their kernels are held at full width per call in phases 7 and 10
PATH9_LAYERS = 8
# since phase 21 came, phase 12's paths (8 layers since its sp and pp
# paths came, 16 before) and phase 6's Mixtral-8x7B (16, 8 since phase
# 22) run cut too (depth the only cut; their kernels are held at full
# width in phases 3 and 10)
PATH12_LAYERS = 8
MIXTRAL_LAYERS = 8
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
# phase 20: LoRA on the families at full width. (i) Mixtral-8x7B,
# LORA_MIX_LAYERS layers, experts stacked, attention unfused, quantized
# head, adapters on
# q/k/v/o (the default targets), batch LORA_MIX_B x LORA_MIX_S (511 rows:
# K2 forward, K3 backward; the MoE block takes the dense expert loop over
# the stacked experts' views); its gradient check against the plain route
# runs on the first LORA_MIX_GRAD_LAYERS layers (depth the only cut: the
# plain route's activations of 32 layers in f32 do not fit beside the
# codes). (ii) GPT-NeoX-20B, LORA_NEOX_LAYERS layers, adapters on every
# block linear (NEOX_TARGETS), batch LORA_NEOX_B x LORA_NEOX_S (1022
# rows). (iii) the finetune CLI on a GPT-NeoX checkpoint at 20B widths and
# LORA_CLI_LAYERS layers that the phase saves itself. Since phase 21 grew
# (sequence parallelism and the pipeline; the script took 994.8 s with
# phase 20 at full depth on an H100 80GB HBM3 at 700 W), (i) runs 16 of
# Mixtral's 32 layers (8 since phase 22 came) and (ii) 22 of
# GPT-NeoX-20B's 44 (11 since phase 25 came: the whole script reached
# phase 25 at 987.6 s on an H100 80GB HBM3 at 700 W): depth the only cut,
# the widths the published ones.
LORA_MIX_LAYERS, LORA_NEOX_LAYERS = 8, 11
LORA_MIX_B, LORA_MIX_S, LORA_MIX_GRAD_LAYERS = 1, 512, 4
LORA_NEOX_B, LORA_NEOX_S = 2, 512
LORA_CLI_LAYERS = 2
NEOX_TARGETS = ("query_key_value", "dense", "dense_h_to_4h", "dense_4h_to_h")
# K2 and K3 at the shapes phase 20 gives them, one plane set, at its rows:
# (name, q_out, q_in, m). Mixtral's w1 and w3 run as separate views of
# the stacked w13 (the second starts at row 14336 of the expert's planes).
LORA_SHAPES = [("mix_q_o", 4096, 4096, 511), ("mix_k_v", 1024, 4096, 511),
               ("mix_w1_w3", 14336, 4096, 511), ("mix_w2", 4096, 14336, 511),
               ("mix_head", 32000, 4096, 511),
               ("neox_qkv", 18432, 6144, 1022),
               ("neox_dense", 6144, 6144, 1022),
               ("neox_h_to_4h", 24576, 6144, 1022),
               ("neox_4h_to_h", 6144, 24576, 1022),
               ("neox_head", 50432, 6144, 1022)]
# their calls per training forward (K2: every quantized linear) and per
# step (K3: less the linears whose input needs no gradient, those that
# read layer 0's norm of the embedding: Mixtral's q/k/v, and GPT-NeoX's
# qkv and h_to_4h under its parallel residual)
_ML, _NL = LORA_MIX_LAYERS, LORA_NEOX_LAYERS
LORA_K2_CALLS = {
    "mixtral": {"mix_q_o": 2 * _ML, "mix_k_v": 2 * _ML,
                "mix_w1_w3": 2 * 8 * _ML, "mix_w2": 8 * _ML, "mix_head": 1},
    "neox": {"neox_qkv": _NL, "neox_dense": _NL, "neox_h_to_4h": _NL,
             "neox_4h_to_h": _NL, "neox_head": 1}}
LORA_K3_CALLS = {
    "mixtral": dict(LORA_K2_CALLS["mixtral"], mix_q_o=2 * _ML - 1,
                    mix_k_v=2 * (_ML - 1)),
    "neox": dict(LORA_K2_CALLS["neox"], neox_qkv=_NL - 1,
                 neox_h_to_4h=_NL - 1)}
# (a): the int8 KV cache's logits against the bf16 cache's, a share of
# max|logit| (int8 codes round at 1/254 of a row's max, bf16 at 2^-9 of
# each value; both then go through 32 random layers, hence the bf16
# kernel-vs-plain tolerance doubled)
INT8_TOL = 0.1
# (b): requests to the serving engine, drawn from seed 0: how many, prompt
# lengths and max_new_tokens (uniform in each range)
SERVE_N, SERVE_PROMPT, SERVE_NEW = 16, (16, 512), (32, 128)
# phase 18 (i): GPT-NeoX-20B at full width, NEOX_LAYERS of its 44 layers
# (44 until phase 23 came; depth the only cut): the fields of the
# published EleutherAI/gpt-neox-20b config.json that
# ModelConfig.from_hf_config reads, written here (nothing is downloaded)
NEOX_LAYERS = 22
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
NEOX_CALLS = {name: NEOX_LAYERS for name, *_ in NEOX_SHAPES[:4]}
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
# phase 19: Llama-2-7B widths quantized on the card (depth the only cut:
# 1 layer since phase 21 grew, 2 before; ~60 s a layer on an NVIDIA H100
# 80GB HBM3 at 700 W)
# from QUANT_ROWS x QUANT_SEQ synthetic calibration tokens (16384 Hessian
# rows, more than the widest input, 11008)
QUANT_LAYERS = 1
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
    from concurrent.futures import ThreadPoolExecutor

    def sass(name):
        return subprocess.run([cu, "-sass", _build._target(name)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    # one cuobjdump per library, all started together
    t = time.time()
    with ThreadPoolExecutor(len(sources)) as ex:
        texts = list(ex.map(sass, sources))
    log(f"sass: {len(sources)} libraries disassembled in "
        f"{time.time() - t:.1f} s")
    for name, text in zip(sources, texts):
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
            text)]
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


def main_model():
    """The main path's model: Llama-2-7B E8P12 (random codes, seed 0),
    fused, quantized head, on the card."""
    import torch
    import quip_for_all_tpu_torch as qt
    cfg = qt.llama2_7b_config()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    return cfg, qt.fuse_for_inference(cfg, model)


def phase_main():
    """The Llama-2-7B path; returns its kernel launches."""
    import torch
    t = time.time()
    cfg, model = main_model()
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
    """The Mixtral-8x7B path at full width and MIXTRAL_LAYERS layers.
    Returns its launch counts and its step times."""
    import dataclasses
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.models.config import mixtral_8x7b_config
    from quip_for_all_tpu_torch.runtime.serving import ServingEngine
    cfg = dataclasses.replace(mixtral_8x7b_config(),
                              num_hidden_layers=MIXTRAL_LAYERS)
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
    """(i) GPT-NeoX-20B E8P12 nibble at full width and NEOX_LAYERS of its
    44 layers (random codes, seed 0, quantized head; phase 18)."""
    import gc
    import numpy as np
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.models.config import ModelConfig
    cfg = dataclasses.replace(ModelConfig.from_hf_config(NEOX_20B_HF),
                              num_hidden_layers=NEOX_LAYERS)
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
                    tm.F32_SPLIT_OPS_PER_S
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
    """Llama-2-7B at full width and PATH9_LAYERS layers in the byte-cut
    layouts: (a) E8P12 u3 and (b) E8P12RVQ4B pb through the row-pair
    kernels, (c) E8P12RVQ4B nibble through fused_decode_matmul with 2
    plane sets. Each path runs with the launch counts set to 0 just before
    and read just after. Returns {path: launches, step times}."""
    import dataclasses
    import gc
    import torch
    import quip_for_all_tpu_torch as qt
    cfg = dataclasses.replace(qt.llama2_7b_config(),
                              num_hidden_layers=PATH9_LAYERS)
    S, NEW, CACHE = 32, 32, 2048
    per_step = 4 * PATH9_LAYERS + 1
    log(f"phase 9: the byte-cut paths run {PATH9_LAYERS} of Llama-2-7B's "
        f"{LAYERS} layers (depth the only cut, for the script's time)")
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
            f"({PATH9_LAYERS} layers; random codes, seed 0, fused, quantized "
            f"head) in "
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
                    tm.F32_SPLIT_OPS_PER_S
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
    """Llama-2-7B at full width and PATH12_LAYERS layers through the new
    kernels: (f) the main path's E8P12 nibble planes (``main``, whose model
    this phase takes, cuts to its first PATH12_LAYERS blocks and frees)
    with split-K = 4, (e) the same planes re-laid as sw4 (a view) and (d)
    as bfp (copied one linear at a time), each held to the cut model's f32
    logits through K1, then (g) E8P12RVQ4B in the paired layout built from
    seed 0. Per forward pass (L layers): (d) 4L + 1 K10, (e) 4L + 1 K11,
    (f) 3L + 1 K6 (qkv, o, gate/up, head) and L K1 (down's 11 lane blocks
    do not split 4 ways), (g) 4L + 1 K7; the 32-token prefill has padded m
    32, so split-K runs there too."""
    import dataclasses
    import gc
    import torch
    from torch import nn
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.ops import qtensor as Q
    L = PATH12_LAYERS
    cfg = dataclasses.replace(main["cfg"], num_hidden_layers=L)
    prompt = main["prompt"]
    model = main.pop("model")
    model.layers = nn.ModuleList(list(model.layers)[:L])
    _, ref = f32_logits(cfg, model, prompt)
    per_step = 4 * L + 1
    out = {}
    for tag, expect, to, back in (
            ("f_ksplit4", {"ksplit_decode_matmul": 3 * L + 1,
                           "fused_decode_matmul": L},
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
        log(f"{tag}: f32 logits of the prompt and 3 greedy steps against "
            f"the same {L} layers' fused_decode_matmul run: "
            f"max|diff|/max|logit| {rel:.3g} (tol 1e-4)")
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
    log(f"g_paired: built Llama-2-7B E8P12RVQ4B [paired] ({L} layers; "
        f"random codes, seed 0, fused, quantized head) in "
        f"{time.time() - t:.1f} s; "
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
    replaced by those recorded, so that a second run (a generate, or a
    training step) takes the first run's top-k experts and weights; a
    replayed value is the recorded one bit for bit, and its gradient goes
    to the run's own router logits. Yields a one-element list that
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
            logits.append(y.detach())
            return y
        r = next(recorded)
        own, rec = (torch.topk(t.float(), k, dim=-1).indices.sort(
            dim=-1).values for t in (y, r))
        flips[0] = flips[0] + (own != rec).any(dim=-1).sum()
        return r + (y - y.detach())
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
    MoE kernel runs on every decode step of the kernel run. Returns how
    many of the n greedy tokens the runs share before they fork."""
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
    return same


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
    for name, q_out, q_in, ms, sets in kernel_cases(K3_SHAPES, K3_M):
        G = q_in // 8
        qt2 = random_qtensor("E8P12RVQ4B", None, q_out, q_in, gen, "cuda")
        for n_sets in sets:
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
                for m in ms:
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
                        tm.F32_SPLIT_OPS_PER_S
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
    log_lora_sums("k3", rows, LORA_K3_CALLS, "step")
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
    for name, q_out, q_in, ms_, sets in kernel_cases(K3_SHAPES, K2_M):
        G = q_in // 8
        qt2 = random_qtensor("E8P12RVQ4B", None, q_out, q_in, gen, "cuda")
        for n_sets in sets:
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
                ms = ms_ + ((DENSE_M[-1],) if n_sets == 1 and name in
                            K2_CALLS and dtype == torch.bfloat16 else ())
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
                        tm.F32_SPLIT_OPS_PER_S
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
                    if m in DENSE_M and n_sets == 1 and name in \
                            K2_CALLS and dtype == torch.bfloat16:
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
    log_lora_sums("k2", rows, LORA_K2_CALLS, "forward")
    for m in DENSE_M:
        d = call_sum(dense, K2_CALLS, "ms", m=m)
        k = call_sum(dense, K2_CALLS, "k2_ms", m=m)
        log(f"kernel k2 fused/dense crossover at m={m} (bf16, 1 set, 225 "
            f"calls): dense route {d:.3f} ms, K2 {k:.3f} ms, dense/K2 "
            f"{d / k:.2f}x (FUSED_MAX_M 1025 sends {m} rows to "
            f"{'K2' if m < 1025 else 'the dense route'})")
    return rows, max_err


def kernel_cases(shapes, ms):
    """Phases 13 and 16's cases: (name, q_out, q_in, rows, plane sets) of
    Llama-2-7B's training shapes at ``ms`` with 1 and 2 plane sets, then
    phase 20's shapes (``LORA_SHAPES``) at their own rows with one."""
    return ([(n, qo, qi, ms, (1, 2)) for n, qo, qi in shapes]
            + [(n, qo, qi, (m,), (1,)) for n, qo, qi, m in LORA_SHAPES])


def lora_sums(rows, calls):
    """A model's per-forward (K2) or per-step (K3) sums of the per-call
    numbers at phase 20's shapes (bf16, 1 plane set), each shape times
    its calls."""
    return {key: call_sum(rows, calls, key, dtype="bfloat16", sets=1)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}


def log_lora_sums(kernel, rows, calls, per):
    for model, c in calls.items():
        log(f"kernel {kernel} per phase 20 {model} training {per}'s "
            f"{sum(c.values())} calls (bf16, 1 set): " + ", ".join(
                f"{k} {v:.3f}" for k, v in lora_sums(rows, c).items()))


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


def epoch_losses(tag, run) -> list:
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
    log(f"{tag}: train_lora ran in {time.time() - t:.1f} s")
    return [float(m.group(1)) for m in (
        re.match(r"lora epoch \d+ train loss ([\d.]+)$", r)
        for r in records) if m]


def offset_lora_b(model, seed=0):
    """Every adapter's B off zero (seeded, x 1e-3), so that A takes
    gradients in the comparisons; returns the adapters by name."""
    import torch
    from quip_for_all_tpu_torch.nn.lora import collect_lora_trainable
    flat = collect_lora_trainable(model.layers, "layers")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for k, p in flat.items():
            if k.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 1e-3)
    return flat


def lora_grad_check(tag, cfg, model, ids, per_fwd, per_bwd):
    """Every adapter gradient of one step, kernels against the plain route,
    with the launch counts of the kernel run's forward and backward: in
    f32 the worst max|diff|/max|grad| within 1e-3, in bf16 the cosine of
    the flattened gradients at least 0.99. On an MoE model the kernel run
    takes the plain run's router logits (``shared_routing``, as
    ``check_plain`` does): a top-2 choice that a near-tie flips between
    the two routes' roundings would otherwise send tokens to other
    experts."""
    import torch
    moe = cfg.arch == "mixtral"
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        router = []
        for impl in ("plain", "auto"):
            ctx = (shared_routing(model, cfg.num_experts_per_tok, router,
                                  replay=impl == "auto")
                   if moe else contextlib.nullcontext([0]))
            reset_launches()
            with ctx as flips:
                loss, grads[impl], _ = adapter_grads(
                    cfg, model, ids, {"compute_dtype": dt,
                                      "matmul_impl": impl})
            launches = read_launches()
            if moe and impl == "auto":
                n = ids.shape[0] * (ids.shape[1] - 1) * len(model.layers)
                log(f"{tag} [{dt}]: the kernel run took the plain run's "
                    f"routing ({flips[0]} of {n} token-layer top-2 choices "
                    "would have differed)")
            check_launches(f"{tag} [{impl}, {dt}] one step", launches,
                           {} if impl == "plain" else
                           {"fused_decode_matmul_tc": per_fwd,
                            "fused_decode_matmul_bwd": per_bwd})
            log(f"{tag} [{impl}, {dt}]: loss {loss:.6g}")
        keys = sorted(grads["auto"])
        if dt == torch.float32:
            worst = max((float((grads["auto"][k] - grads["plain"][k]).abs()
                               .max() / grads["plain"][k].abs().max()), k)
                        for k in keys)
            log(f"{tag} [f32]: adapter gradients, kernels vs plain route: "
                f"worst max|diff|/max|grad| {worst[0]:.3g} ({worst[1]}; tol "
                f"1e-3) over {len(keys)} tensors")
            if not worst[0] <= 1e-3:
                raise AssertionError(f"{tag} f32 gradients differ: {worst}")
        else:
            a = torch.cat([grads["auto"][k].flatten().float() for k in keys])
            b = torch.cat([grads["plain"][k].flatten().float() for k in keys])
            cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
            per = min(float(torch.nn.functional.cosine_similarity(
                grads["auto"][k].flatten().float(),
                grads["plain"][k].flatten().float(), dim=0)) for k in keys)
            log(f"{tag} [bf16]: adapter gradients, kernels vs plain route: "
                f"cosine of the flattened gradients {cos:.6f} (tol >= 0.99);"
                f" lowest per tensor {per:.4f}")
            if not cos >= 0.99:
                raise AssertionError(f"{tag} bf16 gradient cosine {cos}")


def lora_timed_step(tag, cfg, model, ids, per_fwd, per_bwd):
    """The step timed (bf16 compute, the default) after one warm-up step,
    with its exact launches; then one step with a CUDA event pair around
    every K2 and K3 launch. Returns its numbers."""
    import torch
    adapter_grads(cfg, model, ids, {})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, _, (fwd_ms, bwd_ms) = adapter_grads(cfg, model, ids, {})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches(f"{tag} step (bf16)", launches,
                   {"fused_decode_matmul_tc": per_fwd,
                    "fused_decode_matmul_bwd": per_bwd})
    names = ("fused_decode_matmul_tc", "fused_decode_matmul_bwd")
    with kernel_events(names) as pairs:
        adapter_grads(cfg, model, ids, {})
    torch.cuda.synchronize()
    ev = {n: sum(a.elapsed_time(b) for a, b in pairs[n]) for n in names}
    B, S = ids.shape
    rows = B * (S - 1)
    step_ms = fwd_ms + bwd_ms
    log(f"{tag} step (batch {B} x {S}, {rows} rows, bf16): forward "
        f"{fwd_ms:.1f} ms + backward {bwd_ms:.1f} ms = {step_ms:.1f} ms "
        f"({rows / step_ms * 1e3:.1f} rows/s); K2 {ev[names[0]]:.1f} ms over "
        f"{len(pairs[names[0]])} launches, K3 {ev[names[1]]:.1f} ms over "
        f"{len(pairs[names[1]])} launches (CUDA events); peak {peak:.2f} GiB")
    return {"launches": launches["fused_decode_matmul_bwd"],
            "k2_launches": launches["fused_decode_matmul_tc"],
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "k2_ms": ev[names[0]],
            "k3_ms": ev[names[1]], "peak_gib": peak,
            "rows_per_s": rows / step_ms * 1e3}


def lora_adamw(tag, cfg, model, flat, toks, targets, lr=1e-4):
    """8 AdamW steps at ``lr`` (the CLI's by default) on the one batch
    ``toks`` (8 epochs of one step), B back at zero (a fresh start); the
    losses are read from train_lora's per-epoch log lines, and no step may
    rise."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.quantize.lora_train import train_lora
    with torch.no_grad():
        for k, p in flat.items():
            if k.endswith("lora_B"):
                p.zero_()
    hist = epoch_losses(tag, lambda: train_lora(
        cfg, model, toks, rank=8, alpha=16.0, targets=targets, lr=lr,
        epochs=8, batch_size=toks.shape[0]))
    rises = sum(b > a for a, b in zip(hist, hist[1:]))
    log(f"{tag}: train_lora, 8 AdamW steps (lr {lr:g}) on one batch: losses "
        + ", ".join(f"{v:.5f}" for v in hist)
        + f" ({rises} step-to-step rises)")
    if not (len(hist) == 8 and np.all(np.isfinite(hist)) and rises == 0
            and hist[-1] < hist[0]):
        raise AssertionError(f"{tag}: loss did not fall at every step: "
                             f"{hist}")
    return hist


def phase_train():
    """LoRA fine-tuning of Llama-2-7B E8P12 at full width (phase 14)."""
    import gc
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.data.calibration import synthetic_tokens
    from quip_for_all_tpu_torch.nn.lora import DEFAULT_TARGETS, add_lora
    from quip_for_all_tpu_torch.runtime import generate as G
    cfg = qt.llama2_7b_config()
    per_fwd = 7 * LAYERS + 1                    # every quantized linear
    per_bwd = per_fwd - 3                       # less layer 0's q/k/v
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    add_lora(model, rank=8, alpha=16.0)
    flat = offset_lora_b(model)
    torch.cuda.synchronize()
    log(f"train: built Llama-2-7B E8P12 (random codes, seed 0, unfused, "
        f"quantized head) with rank-8 adapters on {len(flat) // 2} linears "
        f"in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    toks = synthetic_tokens(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0)
    ids = torch.as_tensor(toks, device="cuda")
    lora_grad_check("train", cfg, model, ids, per_fwd, per_bwd)
    train = lora_timed_step("train", cfg, model, ids, per_fwd, per_bwd)
    lora_adamw("train", cfg, model, flat, toks, DEFAULT_TARGETS)

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


def lora_family_model(tag, cfg, targets, note):
    """A random E8P12 model of ``cfg`` on the card (seed 0, bf16, quantized
    head) with rank-8 adapters on ``targets``, B off zero."""
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.nn.lora import add_lora
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    add_lora(model, rank=8, alpha=16.0, targets=targets)
    flat = offset_lora_b(model)
    torch.cuda.synchronize()
    log(f"{tag}: built {note} (random codes, seed 0, quantized head) with "
        f"rank-8 adapters on {len(flat) // 2} linears (targets "
        f"{' '.join(targets)})"
        f" in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    return model, flat


def lora_generate(tag, cfg, model, prompt, n, expect):
    """Greedy ``generate`` of n tokens with the trained adapters: graphed
    (bf16) bitwise the eager step loop with the exact launches
    ``expect(forwards)`` gives, then f32 tokens of the kernels against the
    plain route (``check_plain``, which on Mixtral gives the kernel run the
    plain run's routing), all n equal."""
    import torch
    out = {}
    for kind, graphs in (("graphed", None), ("eager", False)):
        run = timed_generate(cfg, model, prompt, 64, graphs=graphs)
        reset_launches()
        (ids, logits), t = run(n)
        check_launches(f"{tag}: generate with adapters ({kind}, bf16)",
                       read_launches(), expect(forwards(run.runner)))
        out[kind] = (ids, torch.stack(logits), t)
    (ids_g, lg_g, t_g), (ids_e, lg_e, t_e) = out["graphed"], out["eager"]
    same = torch.equal(ids_g, ids_e) and torch.equal(lg_g, lg_e)
    log(f"{tag}: generate {n} greedy tokens with the trained adapters: "
        f"graphed {t_g / n * 1e3:.2f} ms/token, eager {t_e / n * 1e3:.2f} "
        f"ms/token (host clock over the call); graphed ids and logits "
        f"bitwise the eager loop's: {same}; bf16 tokens "
        f"{ids_g[0, prompt.shape[1]:].tolist()}")
    if not (same and torch.isfinite(lg_g).all()):
        raise AssertionError(f"{tag}: graphed generate with adapters "
                             "differs from the eager loop")
    equal = check_plain(cfg, model, prompt, torch.float32, 1e-3, 64, n=n,
                        tag=f"{tag} generate")
    if equal != n:
        raise AssertionError(f"{tag}: f32 kernel tokens fork from the plain "
                             f"route's after {equal} of {n}")
    return {"graphed_ms_tok": t_g / n * 1e3, "eager_ms_tok": t_e / n * 1e3}


def phase_lora_families():
    """Phase 20: LoRA on the families at full width, (i) Mixtral-8x7B and
    (ii) GPT-NeoX-20B through K2 and K3, then (iii) the finetune CLI on a
    GPT-NeoX checkpoint."""
    import dataclasses
    import gc
    import torch
    from quip_for_all_tpu_torch.data.calibration import synthetic_tokens
    from quip_for_all_tpu_torch.models.config import (ModelConfig,
                                                      mixtral_8x7b_config)
    from quip_for_all_tpu_torch.models.llama import LlamaModel
    from quip_for_all_tpu_torch.nn.lora import DEFAULT_TARGETS
    out = {}

    # (i) Mixtral-8x7B: 4 attention linears and 3 of each of the 8 experts
    # per layer, and the head (the router stays dense)
    cfg = dataclasses.replace(mixtral_8x7b_config(),
                              num_hidden_layers=LORA_MIX_LAYERS)
    L, E = cfg.num_hidden_layers, cfg.num_local_experts
    per_layer = 4 + 3 * E
    model, flat = lora_family_model(
        "lora (i)", cfg, DEFAULT_TARGETS,
        f"Mixtral-8x7B E8P12 ({L} layers, experts stacked, attention "
        "unfused)")
    toks = synthetic_tokens(LORA_MIX_B, LORA_MIX_S, cfg.vocab_size, seed=0)
    ids = torch.as_tensor(toks, device="cuda")
    g = LORA_MIX_GRAD_LAYERS
    shallow = LlamaModel(model.embed_tokens.weight, list(model.layers[:g]),
                         model.norm.weight, model.lm_head)
    log(f"lora (i): the gradient check runs on the first {g} of {L} layers "
        f"(depth cut: the plain route's f32 activations of {L} layers do "
        "not fit beside the codes); the timed step and train_lora run all "
        f"{L}")
    lora_grad_check("lora (i)", dataclasses.replace(cfg, num_hidden_layers=g),
                    shallow, ids, g * per_layer + 1, g * per_layer + 1 - 3)
    del shallow
    per_fwd = L * per_layer + 1
    step = lora_timed_step("lora (i)", cfg, model, ids, per_fwd, per_fwd - 3)
    hist = lora_adamw("lora (i)", cfg, model, flat, toks, DEFAULT_TARGETS)
    # the 32-token prompt runs the dense expert loop at 32 rows (K1 for
    # every quantized linear); each decode step the sparse route: K1 for
    # q/k/v/o and the head, K4 for w13 and w2
    gen = lora_generate(
        "lora (i)", cfg, model, torch.as_tensor(toks[:, :32], device="cuda"),
        16, lambda f: {"fused_decode_matmul": per_fwd + (f - 1) * (4 * L + 1),
                       "moe_decode_matmul": (f - 1) * 2 * L})
    out["mixtral_8x7b"] = dict(step, losses=hist, **gen)
    del model, flat
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) GPT-NeoX-20B: 4 linears per layer and the head
    cfg = dataclasses.replace(ModelConfig.from_hf_config(NEOX_20B_HF),
                              num_hidden_layers=LORA_NEOX_LAYERS)
    L = cfg.num_hidden_layers
    model, flat = lora_family_model(
        "lora (ii)", cfg, NEOX_TARGETS,
        f"GPT-NeoX-20B E8P12 ({L} layers)")
    toks = synthetic_tokens(LORA_NEOX_B, LORA_NEOX_S, cfg.vocab_size, seed=0)
    ids = torch.as_tensor(toks, device="cuda")
    per_fwd = 4 * L + 1
    lora_grad_check("lora (ii)", cfg, model, ids, per_fwd, per_fwd - 2)
    step = lora_timed_step("lora (ii)", cfg, model, ids, per_fwd,
                           per_fwd - 2)
    # lr 5e-5: at the CLI's 1e-4 the loss of this model falls faster than
    # Llama-2-7B's and its 8th step overshoots (5.42 -> 6.51 on an H100,
    # PERF.md section 6); half the lr keeps 8 steps on the descent
    hist = lora_adamw("lora (ii)", cfg, model, flat, toks, NEOX_TARGETS,
                      lr=5e-5)
    gen = lora_generate(
        "lora (ii)", cfg, model, torch.as_tensor(toks[:1, :32],
                                                 device="cuda"),
        16, lambda f: {"fused_decode_matmul": per_fwd * f})
    out["gpt_neox_20b"] = dict(step, losses=hist, **gen)
    del model, flat
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = lora_cli(cfg)
    return out


def lora_cli(cfg):
    """(iii) ``cli.finetune_lora --device cuda --targets ...`` on a
    GPT-NeoX checkpoint at ``cfg``'s widths and LORA_CLI_LAYERS layers
    that ``save_quantized`` writes here; the written adapters loaded with
    ``load_lora`` and with ``import_peft`` onto ``load_quantized``'s model
    give the trained model's logits (f32 compute), bit for bit."""
    import dataclasses
    import shutil
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.cli import finetune_lora
    from quip_for_all_tpu_torch.quantize import lora_train
    cfg = dataclasses.replace(cfg, num_hidden_layers=LORA_CLI_LAYERS)
    ckpt = os.path.join(REPO, "build", "lora_neox_ckpt")
    out = os.path.join(REPO, "build", "lora_neox_adapters")
    for d in (ckpt, out):
        shutil.rmtree(d, ignore_errors=True)
    t = time.time()
    qt.save_quantized(cfg, qt.random_quantized_model(
        cfg, seed=0, quantize_head=True, device="cuda"), {
            "quant_method": "QUiP", "codebook": "E8P12", "use_rand": True,
            "per_channel": False, "opt_resid_scale": -1, "tp_shards": 1},
        ckpt)
    trained = []
    orig = lora_train.train_lora

    def keep(*a, **k):
        trained.append(orig(*a, **k))
        return trained[-1]
    lora_train.train_lora = keep
    try:
        finetune_lora.main([
            "--model-path", ckpt, "--save-dir", out, "--dataset",
            "synthetic", "--nsamples", "4", "--valid-samples", "0",
            "--seqlen", "128", "--batch-size", "2", "--epochs", "1",
            "--lr", "1e-3", "--device", "cuda", "--targets", *NEOX_TARGETS])
    finally:
        lora_train.train_lora = orig
    files = sorted(os.listdir(out))
    x = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3))
    f32 = {"compute_dtype": torch.float32}
    apply = qt.get_arch(cfg).model_apply
    with torch.no_grad():
        want = apply(cfg, trained[0], x, linear_kw=f32)[0]
        got = {}
        for how, fn in (("load_lora", lora_train.load_lora),
                        ("import_peft", lora_train.import_peft)):
            base = qt.load_quantized(ckpt, device="cuda")[1]
            got[how] = apply(cfg, fn(base, out, device="cuda"), x,
                             linear_kw=f32)[0]
    same = {how: bool(torch.equal(v, want)) for how, v in got.items()}
    log(f"lora (iii): cli.finetune_lora --device cuda --targets "
        f"{' '.join(NEOX_TARGETS)} on a GPT-NeoX checkpoint ({LORA_CLI_LAYERS}"
        f" layers at 20B widths, written by save_quantized) in "
        f"{time.time() - t:.1f} s wrote {files}; f32 logits of the loaded "
        f"adapters equal the trained model's: {same}")
    if not all(same.values()) or len(files) != 4:
        raise AssertionError("lora (iii): the CLI's adapters load back "
                             "otherwise")
    return {"seconds": time.time() - t, "files": files}


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
        tol = tol + tm._bf16_ulp(torch.maximum(g.abs(), w.abs()))
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
    """(iv) a full-width E8P12RVQ4B nibble model (phase 9's depth) with
    both switches on
    (right epilogue, combine 8): 32 greedy tokens graphed, exact K1
    launches, held to its plain twin in bf16 and f32, one graphed step's
    device time; both switched off again."""
    import torch
    import quip_for_all_tpu_torch as qt
    S, NEW, CACHE = prompt.shape[1], 32, 2048
    per_step = 4 * cfg.num_hidden_layers + 1
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


def lora_entry(e, rows, calls, lora, what):
    """Phase 20's numbers beside a K2 or K3 entry: its launches in each
    model's counted step and, per training ``what`` of each model, the
    sums of the per-call numbers at that model's shapes."""
    e.setdefault("launches_by_path", {}).update({
        f"{m}_lora_step": lora[m]["launches" if what == "step"
                                  else "k2_launches"]
        for m in ("mixtral_8x7b", "gpt_neox_20b")})
    for m, c in (("mixtral_8x7b", calls["mixtral"]),
                 ("gpt_neox_20b", calls["neox"])):
        e[f"{m}_per_lora_{what}"] = dict(lora_sums(rows, c),
                                         calls=sum(c.values()))


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
        f"llama2_7b_{PATH9_LAYERS}_layers_rvq4b_nibble":
            paths["c_rvq4b_nibble"]["launches"]}
    moe = entry(KERNELS[1], moe_rows, moe_calls, {"R": 2},
                mix["launches"]["moe_decode_matmul"], moe_err)
    moe.update(moe_sums(moe_rows))
    moe["mixtral_16_token_sparse_prefill_device_ms"] = mix[
        "sparse_prefill_device_ms"]
    # Mixtral's decode step: its fused calls (GQA qkv, o, head) and its
    # MoE calls, against the graphed step's device time
    mix_fused = call_sum(rows, MIXTRAL_FUSED_CALLS, "ms", m=1, sets=1)
    # phase 6 runs MIXTRAL_LAYERS of the 32 layers: the share of its step
    cut = MIXTRAL_LAYERS / LAYERS
    log(f"mixtral: per decode token of all 32 layers the kernels take "
        f"{mix_fused:.3f} ms (fused_decode_matmul) + {moe['ms']:.3f} ms "
        f"(moe_decode_matmul), bound "
        f"{call_sum(rows, MIXTRAL_FUSED_CALLS, 'bound_ms', m=1, sets=1):.3f}"
        f" + {moe['bound_ms']:.3f} ms; scaled to phase 6's "
        f"{MIXTRAL_LAYERS} layers, {(mix_fused + moe['ms']) * cut:.3f} ms of "
        f"its {mix['dev_ms']:.3f} ms graphed device time "
        f"({(mix_fused + moe['ms']) * cut / mix['dev_ms']:.0%})")
    entries = [fused, moe]
    # phase 9's paths run PATH9_LAYERS layers: their share of a step
    path_calls = {k: PATH9_LAYERS if v == LAYERS else v
                  for k, v in LLAMA_CALLS.items()}
    for (layout, _, kname), path in zip(ROWPAIR, ("a_u3", "b_pb")):
        e = entry(next(k for k in KERNELS if k["name"] == kname), rp_rows,
                  LLAMA_CALLS, {"kernel": kname, "m": 1, "dtype": "bfloat16"},
                  paths[path]["launches"], rp_err[kname])
        e.update(small_m_sums(rp_rows, {"kernel": kname,
                                        "dtype": "bfloat16"}))
        k_ms = call_sum(rp_rows, path_calls, "ms", kernel=kname, m=1,
                        dtype="bfloat16")
        log(f"{path}: per decode token of its {PATH9_LAYERS} layers the "
            f"{layout} kernel takes {k_ms:.3f} ms of "
            f"{paths[path]['dev_ms']:.3f} ms graphed device time "
            f"({k_ms / paths[path]['dev_ms']:.0%}); Llama-2-7B's 32 layers: "
            f"{e['ms']:.3f} ms, bound {e['bound_ms']:.3f} ms")
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
        # phase 12 runs PATH12_LAYERS layers: the kernel's share of a step
        k_ms = e["ms"] * PATH12_LAYERS / LAYERS
        log(f"{path}: per decode token of its {PATH12_LAYERS} layers the "
            f"{label} kernel takes ~{k_ms:.3f} ms (all 32 layers: "
            f"{e['ms']:.3f}) of {paths[path]['dev_ms']:.3f} ms graphed "
            f"device time ({k_ms / paths[path]['dev_ms']:.0%}); bound "
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


# ------------------------------------------------------------ phase 21

TP = 2
TP_PROMPT = 32
TP_STEPS = 8
TP_GREEDY = 32
TP_CACHE = 512
# the rank-local shapes of Llama-2-7B at tp 2: (layer, module path in a
# block, q_out, q_in); the head is the model's lm_head
TP_SHAPES = [("qkv", ("self_attn", "qkv_proj"), 6144, 4096),
             ("o", ("self_attn", "o_proj"), 4096, 2048),
             ("gateup", ("mlp", "gateup_proj"), 11008, 4096),
             ("down", ("mlp", "down_proj"), 4096, 5504),
             ("head", None, 16000, 4096)]
TP_K1_M = (1, 8)
TP_K2 = ("down", 64)
# the same group's sequence-parallel and pipelined paths on the whole
# model: SP_WINDOWS windows of SP_S tokens, one row each (SP_S / TP = 1024
# rows a rank: K2 on every linear, where one rank's 2048 take the dense
# route); the pipeline's PP_B x PP_S ids in PP_M microbatches (512 rows a
# microbatch: K2), and one pipelined finetune step on the same shapes
SP_S, SP_WINDOWS = 2048, 2
PP_B, PP_S, PP_M = 2, 512, 2
# forward launches a rank: every block linear of its layers per row
# block, and the head once over the whole batch
SP_K2 = LAYERS * 4 + 1
PP_K2 = PP_M * (LAYERS // TP) * 4 + 1


def tp_block_diagonal(model, tp):
    """Give every column-parallel quantized linear of ``model`` a right
    transform, and every row-parallel one a left transform, block-diagonal
    over ``tp`` shards (``get_hadK(n, shards=tp)``, random sub-factors from
    a fixed seed), as a checkpoint quantized with ``tp_shards = tp`` has
    them; in place. The codes are random, so the model stays valid."""
    import torch
    from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
    from quip_for_all_tpu_torch.parallel.sharding import role_of
    from quip_for_all_tpu_torch.transforms.incoherence import get_hadK
    gen = torch.Generator(device="cuda").manual_seed(17)
    for name, mod in model.named_modules():
        role = role_of(name) if isinstance(mod, QuantLinear) else "rep"
        if role == "rep":
            continue
        side = "right" if role == "col" else "left"
        n = mod.q_out if role == "col" else mod.q_in
        spec = get_hadK(n, use_rand=True, generator=gen, device="cuda",
                        shards=tp)
        had = None if spec.hadK is None else spec.hadK.to(mod.SV.dtype)
        setattr(mod, f"had_{side}", had)
        setattr(mod, f"K_{side}", spec.K)
        setattr(mod, f"shards_{side}", tp)
    return model


def tp_model(cfg):
    """Llama-2-7B E8P12 nibble, random codes from seed 0, the main path's
    options (quantized head, fused qkv and gate/up), with the tp_shards
    transforms of ``tp_block_diagonal``: (the model unfused, as the
    quantizer's finetune takes it, and fused; they share every module but
    the fused groups)."""
    import quip_for_all_tpu_torch as qt
    model = tp_block_diagonal(qt.random_quantized_model(
        cfg, seed=0, quantize_head=True, device="cuda"), TP)
    return model, qt.fuse_for_inference(cfg, model)


def tp_inputs(cfg):
    import numpy as np
    rng = np.random.default_rng(21)
    ids = rng.integers(0, cfg.vocab_size, (1, TP_PROMPT + TP_STEPS))
    reqs = [(p, 16) for p, _ in serving_requests(cfg, 4, 21, (16, 200),
                                                 (16, 16))]
    return ids, reqs


def tp_f32_logits(cfg, model, ids):
    """f32 logits (f32 compute) of a prefill of the first TP_PROMPT ids
    and TP_STEPS cached one-token steps on the rest: (S, V)."""
    import torch
    from quip_for_all_tpu_torch.models.registry import get_arch, rank_config
    from quip_for_all_tpu_torch.runtime.generate import init_kv_caches
    apply = get_arch(cfg).model_apply
    kw = dict(dtype=torch.float32,
              linear_kw={"compute_dtype": torch.float32})
    ids = torch.as_tensor(ids).cuda()
    caches = init_kv_caches(rank_config(cfg, model), 1, TP_CACHE,
                            torch.float32, "cuda")
    n0 = TP_PROMPT
    with torch.no_grad():
        out, _ = apply(cfg, model, ids[:, :n0],
                       positions=torch.arange(n0, device="cuda")[None],
                       kv_caches=caches, cache_position=0, **kw)
        outs = [out[0]]
        for t in range(n0, ids.shape[1]):
            out, _ = apply(cfg, model, ids[:, t:t + 1],
                           positions=torch.full((1, 1), t, device="cuda"),
                           kv_caches=caches, cache_position=t, **kw)
            outs.append(out[0])
    return torch.cat(outs).cpu().numpy()


def tp_greedy(cfg, model, ids, n=TP_GREEDY):
    """``n`` greedy bf16 tokens after the prompt, by ``generate`` (a
    card's graphs for a whole model, the eager loop for a rank's), with
    the host time a token after the prefill."""
    import torch
    import quip_for_all_tpu_torch as qt
    prompt = torch.as_tensor(ids[:, :TP_PROMPT]).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = qt.generate(cfg, model, prompt, n, cache_len=TP_CACHE)
    torch.cuda.synchronize()
    return out[0, TP_PROMPT:].cpu().numpy(), \
        (time.perf_counter() - t0) * 1e3 / n


def tp_serve(cfg, model, reqs, mesh=None):
    """The 4 requests through ``ServingEngine`` at 4 slots in f32 (a
    prefill chunk of 4 x 128 rows runs K2, a decode step K1)."""
    import torch
    from quip_for_all_tpu_torch.runtime.serving import ServingEngine
    eng = ServingEngine(cfg, model, max_batch=4, cache_len=TP_CACHE,
                        prefill_chunk=128, decode_chunk=8,
                        dtype=torch.float32, mesh=mesh,
                        linear_kw={"compute_dtype": torch.float32})
    rids = [eng.add_request(p, m) for p, m in reqs]
    res = eng.run()
    return [res[r] for r in rids], eng.prefill_chunks, eng.decode_steps


def tp_step_ms(cfg, model, stub=False, n=8):
    """Host ms of one eager bf16 decode step of a rank's model (``n``
    steps after 2 warm-ups, synchronised), with its collectives, or with
    ``stub`` each replaced by a local stand-in of the same shape (the
    logits are then wrong and thrown away): the difference is what the
    collectives cost a step."""
    import torch
    from quip_for_all_tpu_torch.models.registry import rank_config
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.runtime.generate import (decode_step_fn,
                                                         init_kv_caches)
    saved = comm.all_reduce, comm.all_gather, comm.broadcast
    if stub:
        comm.all_reduce = lambda t, group: t
        comm.all_gather = lambda t, group, world: torch.cat([t] * world, -1)
        comm.broadcast = lambda t, src, group: t
    try:
        step = decode_step_fn(cfg)
        caches = init_kv_caches(rank_config(cfg, model), 1, TP_CACHE,
                                torch.bfloat16, "cuda")
        tok = torch.zeros(1, dtype=torch.int64, device="cuda")
        for pos in range(2):
            step(model, caches, tok, pos)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for pos in range(2, 2 + n):
            step(model, caches, tok, pos)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n
    finally:
        comm.all_reduce, comm.all_gather, comm.broadcast = saved


def tp_fork(cfg, model, ids, ref, toks):
    """Where a rank's greedy bf16 tokens leave the one-rank run's: the
    first differing position, and there the one-rank model's gap between
    its top logit and the logit of the rank's token (one bf16 forward
    over the prompt and the rank's tokens), beside one bf16 step at that
    magnitude. None when they agree throughout."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.models.registry import get_arch
    diff = np.nonzero(toks != ref)[0]
    if diff.size == 0:
        return None
    f = int(diff[0])
    seq = np.concatenate([ids[0, :TP_PROMPT], toks[:f + 1]])[None]
    with torch.no_grad():
        logits, _ = get_arch(cfg).model_apply(
            cfg, model, torch.as_tensor(seq).cuda(), dtype=torch.bfloat16)
    row = logits[0, TP_PROMPT + f - 1].float().cpu().numpy()
    top, mine = float(row.max()), float(row[toks[f]])
    step = 2.0 ** (np.floor(np.log2(max(abs(top), 1e-30))) - 7)
    return {"position": f, "gap": top - mine, "bf16_step": float(step)}


def hold_fork(tag, fork):
    """A greedy bf16 fork from the one-rank run passes only at a near-tie:
    the one-rank model's top logit at most one bf16 step above the
    rank's token's there (sum order alone moves a bf16 logit that far)."""
    if fork is not None and fork["gap"] > fork["bf16_step"]:
        raise AssertionError(
            f"{tag}: greedy bf16 tokens leave the one-rank run's at token "
            f"{fork['position']}, where the one-rank model's top logit is "
            f"{fork['gap']:.4g} above the rank's token's (more than one "
            f"bf16 step, {fork['bf16_step']:.4g})")


def tp_kernel_checks(cfg, model):
    """On a rank's model: K1 against its plain twin at m = 1 and 8 on each
    rank-local shape (TP_SHAPES, block 0's planes and the head's), K2 at m
    = 64 on TP_K2's; the existing tolerance (1e-5 of max plus one bf16
    ulp). Returns {case: max error}."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    gen = torch.Generator(device="cuda").manual_seed(21)
    errs = {}
    for name, path, q_out, q_in in TP_SHAPES:
        lin = (model.lm_head if path is None
               else model.layers[0][path[0]][path[1]]).local
        qw = lin.qweight
        if (qw.q_out, qw.q_in) != (q_out, q_in):
            raise AssertionError(f"tp {name}: rank-local planes "
                                 f"{qw.q_out}x{qw.q_in}, want "
                                 f"{q_out}x{q_in}")
        planes, affine = qw.plane_list(), qw.decode_affine
        G, Gp = q_in // 8, qw.group_cols
        scale = torch.rand(q_out, generator=gen, device="cuda") + 0.5
        cases = [(m, fm.fused_decode_matmul) for m in TP_K1_M]
        if name == TP_K2[0]:
            cases.append((TP_K2[1], fm.fused_decode_matmul_tc))
        for m, kern in cases:
            mp = max(8, -(-m // 8) * 8)
            x = torch.zeros((mp, 8, Gp), device="cuda")
            x[:m, :, :G] = torch.randn((m, 8, G), generator=gen,
                                       device="cuda")
            x = x.reshape(mp, 8 * Gp).to(torch.bfloat16)
            got = kern(x, planes, affine, scale, rows=m)
            want = fm.fused_decode_matmul_ref(x[:m], planes, affine, scale)
            torch.cuda.synchronize()
            ok, err = tm.compare(got, want, bf16_step=True)[:2]
            key = f"{'K1' if m <= 32 else 'K2'} {name} {q_out}x{Gp} m={m}"
            errs[key] = err
            if not ok:
                raise AssertionError(f"tp {key}: kernel vs plain twin beyond "
                                     f"tolerance (max |diff| {err})")
    return errs


def sp_pp_inputs(cfg):
    """The windows of the sequence-parallel path (SP_WINDOWS, SP_S), the
    pipeline's ids (PP_B, PP_S) and the finetune step's soft targets
    (PP_B, PP_S, V) on the card, from seed 18 (the same in every
    process)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(18)
    windows = rng.integers(0, cfg.vocab_size, (SP_WINDOWS, SP_S))
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (PP_B, PP_S)),
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(18)
    tgt = torch.softmax(torch.randn((PP_B, PP_S, cfg.vocab_size),
                                    generator=gen, device="cuda"), dim=-1)
    return windows, ids, tgt


def ft_leaves(model):
    """The finetune's trainables of ``model``'s blocks
    (``quantize/finetune.py`` ``collect_trainable``), in f32 (the random
    model's are bf16: signs and ones, exact in f32), installed in it."""
    from quip_for_all_tpu_torch.models.registry import model_layers
    from quip_for_all_tpu_torch.quantize import finetune as FT
    layers = model_layers(model)
    flat = {k: v.detach().float().requires_grad_(True)
            for k, v in FT.collect_trainable(layers).items()}
    FT.apply_trainable(layers, flat)
    return flat


def ft_step(cfg, model, ids, tgt, mesh=None, kernels=False):
    """One end-to-end finetune step's loss and gradients: the student's
    forward as ``QuipQuantizer`` runs it (``finetune.student_logits``, the
    training forward of the linears, the dense W of ``calc_weight`` held
    for the step by ``finetune.dense_weights``), or
    with ``kernels`` the same loss through the eval forward
    (``pipeline_logits`` / ``model_apply`` in f32 compute: K2 forward, K3
    backward, the route of a LoRA step); the whole model, or pipelined
    over ``mesh`` in PP_M microbatches. Returns (loss, {key: grad} of the
    leaves that got one, ms)."""
    import torch
    from quip_for_all_tpu_torch.models.registry import get_arch
    from quip_for_all_tpu_torch.parallel.pipeline import pipeline_logits
    from quip_for_all_tpu_torch.quantize import finetune as FT
    flat = ft_leaves(model)
    kw = {"compute_dtype": torch.float32}
    with (contextlib.nullcontext() if kernels else
          FT.dense_weights(FT.student_modules(cfg, model, mesh))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if not kernels:
            logits = FT.student_logits(cfg, model, ids, mesh, PP_M)
        elif mesh is None:
            logits = get_arch(cfg).model_apply(cfg, model, ids,
                                               linear_kw=kw)[0]
        else:
            logits = pipeline_logits(cfg, model, ids, mesh, PP_M,
                                     linear_kw=kw)
        loss = FT.ce_loss(logits, tgt)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    grads = {k: v.grad.cpu() for k, v in flat.items() if v.grad is not None}
    for v in flat.values():
        v.grad = None
    return float(loss.detach()), grads, ms


def f32_kw():
    import torch
    return {"compute_dtype": torch.float32}


# the fused model's linears (module path in a block; None: the head)
SP_PP_LINEARS = [("qkv", ("self_attn", "qkv_proj")),
                 ("o", ("self_attn", "o_proj")),
                 ("gateup", ("mlp", "gateup_proj")),
                 ("down", ("mlp", "down_proj")), ("head", None)]


def sp_pp_kernel_times(model):
    """K2 (f32 x, at the rows of a sp forward, SP_S / TP, and of a
    microbatch, PP_S) and K3 (f32 g, a microbatch's rows) on the planes of
    block 0's and the head's linears of ``model``: each held to its plain
    twin, timed as phase 16 times K2 (CUDA-graph replays, L2-cold; the
    twin by events), beside the library product (x @ W.T, g @ W with W
    decoded in f32) and the bound (planes, input and output once, 2 m
    q_out q_in operations three times at the bf16 tensor-core rate: the
    kernels split f32 x or g into three bf16 terms). Returns the rows and their
    sums per forward (the block linears x LAYERS, the head once)."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = []
    for name, path in SP_PP_LINEARS:
        qt = (model.lm_head if path is None
              else model.layers[0][path[0]][path[1]]).qweight
        planes, affine, Gp = qt.plane_list(), qt.decode_affine, qt.group_cols
        q_out, G = qt.q_out, qt.q_in // 8
        cp = tm.cold_copies(planes)
        W = decode_weights(qt, dtype=torch.float32)
        Wc = tm.cold_copies([W])
        nb = sum(w.numel() * 4 for w in planes)
        for kernel, m in (("K2", SP_S // TP), ("K2", PP_S), ("K3", PP_S)):
            if kernel == "K2":
                x = torch.zeros((m, 8, Gp), device="cuda")
                x[:, :, :G] = torch.randn((m, 8, G), generator=gen,
                                          device="cuda")
                x = x.reshape(m, 8 * Gp)
                x_nat = x.reshape(m, 8, Gp)[:, :, :G].transpose(
                    1, 2).reshape(m, G * 8).contiguous()
                got = fm.fused_decode_matmul_tc(x, planes, affine)
                want = fm.fused_decode_matmul_ref(x, planes, affine)

                def run(i):
                    return fm.fused_decode_matmul_tc(x, cp[i % len(cp)],
                                                     affine)

                def plain(i):
                    return fm.fused_decode_matmul_ref(x, cp[i % len(cp)],
                                                      affine)

                def lib(i):
                    return torch.matmul(x_nat, Wc[i % len(Wc)][0].T)
            else:
                x = torch.randn((m, q_out), generator=gen, device="cuda")
                got = fm.fused_decode_matmul_bwd(x, planes, affine, None, G,
                                                 Gp)
                want = fm.fused_decode_matmul_bwd_ref(x, planes, affine,
                                                      None, G, Gp)

                def run(i):
                    return fm.fused_decode_matmul_bwd(
                        x, cp[i % len(cp)], affine, None, G, Gp)

                def plain(i):
                    return fm.fused_decode_matmul_bwd_ref(
                        x, cp[i % len(cp)], affine, None, G, Gp)

                def lib(i):
                    return torch.matmul(x, Wc[i % len(Wc)][0])
            torch.cuda.synchronize()
            ok, err = tm.compare(got, want, bf16_step=True)[:2]
            if not ok:
                raise AssertionError(f"{kernel} {name} m={m} f32: kernel vs "
                                     f"plain twin beyond tolerance (max "
                                     f"|diff| {err})")
            nbytes = nb + m * 8 * Gp * 4 + m * q_out * 4
            b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
            b_ops = 2 * m * q_out * G * 8 / tm.F32_SPLIT_OPS_PER_S * 1e3
            row = {"kernel": kernel, "layer": name, "q_out": q_out,
                   "Gp": Gp, "m": m, "max_abs_err": err,
                   "ms": 1e-3 * tm.graph_us(run, 4 * len(cp)),
                   "plain_ms": 1e-3 * tm.event_us(plain, 2),
                   "library_ms": 1e-3 * tm.graph_us(lib, 4 * len(Wc)),
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
            rows.append(row)
            log(f"kernel sp/pp {kernel} {name:6s} {q_out}x{Gp} m={m:4d} f32: "
                f"max|k-plain| {err:.3g} | kernel {row['ms'] * 1e3:.1f} us | "
                f"plain {row['plain_ms'] * 1e3:.1f} us | bound "
                f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}) | "
                f"library {row['library_ms'] * 1e3:.1f} us")
            del x, got, want
        del cp, W, Wc
        torch.cuda.empty_cache()
    sums = {}
    for kernel, m in (("K2", SP_S // TP), ("K2", PP_S), ("K3", PP_S)):
        sums[f"{kernel}_m{m}"] = {key: sum(
            r[key] * (1 if r["layer"] == "head" else LAYERS) for r in rows
            if r["kernel"] == kernel and r["m"] == m)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"kernel sp/pp {kernel} at m={m} (f32) per forward's "
            f"{SP_K2} calls: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sums[f"{kernel}_m{m}"].items()))
    return {"rows": rows, "per_forward": sums}


def sp_pp_refs(cfg, unfused, fused, profile=False):
    """The one-rank references of the sequence-parallel and pipelined
    paths, on the whole model in this process: window 0's f32 logits and
    both windows' perplexity (2048 rows: the dense route), the pipeline
    ids' f32 logits (1024 rows: K2), and the finetune step both ways
    (with ``profile``, the quantizer's step once more under the
    profiler: ``profiled``)."""
    import torch
    from quip_for_all_tpu_torch.models.registry import get_arch
    from quip_for_all_tpu_torch.runtime.generate import perplexity
    windows, ids, tgt = sp_pp_inputs(cfg)
    apply = get_arch(cfg).model_apply
    ref = {}
    with torch.no_grad():
        reset_launches()
        w0 = torch.as_tensor(windows[:1]).cuda()
        ref["sp_logits"] = apply(cfg, fused, w0, linear_kw=f32_kw())[0][0]
        ref["sp_logits"] = ref["sp_logits"].cpu().numpy()
        ref["sp_launches"] = {k: v for k, v in read_launches().items() if v}
        t = time.perf_counter()
        ref["sp_ppl"] = perplexity(cfg, fused, windows, linear_kw=f32_kw(),
                                   device="cuda")
        ref["sp_window_s"] = (time.perf_counter() - t) / SP_WINDOWS
        reset_launches()
        ref["pp_logits"] = apply(cfg, fused, ids, linear_kw=f32_kw())[0]
        ref["pp_logits"] = ref["pp_logits"].cpu().numpy()
        ref["pp_launches"] = {k: v for k, v in read_launches().items() if v}
    for kind, model in (("ft", unfused), ("ft_kernels", fused)):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        free = torch.cuda.mem_get_info()[0] / 2**30
        retries = alloc_retries()
        loss, grads, ms = ft_step(cfg, model, ids, tgt,
                                  kernels=kind == "ft_kernels")
        ref[kind] = {"loss": loss, "grads": grads, "ms": ms,
                     "launches": {k: v for k, v in read_launches().items()
                                  if v},
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "free_gib_before": free,
                     "alloc_retries": alloc_retries() - retries}
        torch.cuda.empty_cache()
    if profile:
        ref["ft_profile"] = profiled(lambda: ft_step(cfg, unfused, ids,
                                                     tgt))[1]
        torch.cuda.empty_cache()
    return ref


def sp_pp_rank(cfg, unfused, fused, out_dir, rank, profile=False):
    """On each rank of phase 21's group, the whole model: window 0's
    logits through ``sequence_parallel_logits`` and both windows through
    ``perplexity(sp_mesh=)`` in f32; ``pipeline_logits`` of the pipeline
    ids; the pipelined finetune step both ways. Every launch and
    collective count set to 0 before each run and read after, with its
    host time, the rank's peak memory, the free device memory before it
    and the allocator's retries in it; with ``profile``, the quantizer's
    pipelined step's first call under a host stack sampler
    (``host_samples``) and its second under the profiler (``profiled``).
    The logits go to files in ``out_dir``; returns the rest."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                          pipeline_logits)
    from quip_for_all_tpu_torch.parallel.sequence import (
        make_sp_mesh, sequence_parallel_logits)
    from quip_for_all_tpu_torch.runtime.generate import perplexity
    windows, ids, tgt = sp_pp_inputs(cfg)
    sp, pp = make_sp_mesh(TP), make_pp_mesh(TP)
    res = {}

    def run(name, fn):
        reset_launches()
        comm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0] / 2**30
        retries = alloc_retries()
        t = time.perf_counter()
        with collective_seconds() as coll_s:
            out = fn()
        torch.cuda.synchronize()
        res[name] = {"s": time.perf_counter() - t,
                     "launches": {k: v for k, v in read_launches().items()
                                  if v},
                     "collectives": comm.counts(),
                     "collective_s": coll_s,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "free_gib_before": free,
                     "alloc_retries": alloc_retries() - retries}
        return out

    with torch.no_grad():
        w0 = torch.as_tensor(windows[:1]).cuda()
        out = run("sp_logits", lambda: sequence_parallel_logits(
            cfg, fused, w0, sp, linear_kw=f32_kw()))
        np.save(os.path.join(out_dir, f"sp{rank}.npy"), out[0].cpu().numpy())
        res["sp_ppl"] = run("sp_perplexity", lambda: perplexity(
            cfg, fused, windows, sp_mesh=sp, device="cuda",
            linear_kw=f32_kw()))
        out = run("pp_logits", lambda: pipeline_logits(
            cfg, fused, ids, pp, PP_M, linear_kw=f32_kw()))
        np.save(os.path.join(out_dir, f"pp{rank}.npy"), out.cpu().numpy())
    del out
    for kind, model in (("ft", unfused), ("ft_kernels", fused)):
        def step():
            return ft_step(cfg, model, ids, tgt, pp,
                           kernels=kind == "ft_kernels")
        if profile and kind == "ft":
            (loss, grads, ms), res["ft_samples"] = run(
                kind, lambda: host_samples(step))
        else:
            loss, grads, ms = run(kind, step)
        res[kind].update(loss=loss, grads=grads, ms=ms)
        torch.cuda.empty_cache()
    if profile:
        res["ft_profile"] = run("ft_again", lambda: profiled(
            lambda: ft_step(cfg, unfused, ids, tgt, pp)))[1]
        torch.cuda.empty_cache()
    return res


def host_samples(step, every_s=0.005, top=15):
    """``step()`` while a thread samples every thread's Python stack each
    ``every_s`` seconds (``chip_smoke.py --phase 21 --profile-ft``: the
    first call of the quantizer's pipelined step, where the profiler would
    change what it measures). Returns its result and a summary: the
    samples taken; the ``top`` innermost frames (file:line function, with
    its caller, the importing line where the frame is the import
    system's, and the innermost frame in the repository, which names the
    line of the port that led there) by samples, by thread; and the
    ``top`` repository frames by samples, split by whether an import was
    running."""
    import collections
    import threading
    stop = threading.Event()
    names = {}
    hits, by_own = collections.Counter(), collections.Counter()
    taken = [0]

    def where(f):
        path = f.f_code.co_filename.split(os.sep)[-2:]
        return f"{'/'.join(path)}:{f.f_lineno} {f.f_code.co_name}"

    def outer(f, keep):
        while f is not None and not keep(f.f_code.co_filename):
            f = f.f_back
        return where(f) if f is not None else ""

    def sample():
        while not stop.wait(every_s):
            taken[0] += 1
            for ident, f in sys._current_frames().items():
                if ident == sampler.ident:
                    continue
                name = names.setdefault(ident, next(
                    (t.name for t in threading.enumerate()
                     if t.ident == ident), str(ident)))
                # the caller; in an import, the importing line
                caller = outer(f.f_back,
                               lambda n: not n.startswith("<frozen"))
                own = outer(f, lambda n: n.startswith(REPO))
                hits[(name, where(f), caller, own)] += 1
                importing = any(
                    g.f_code.co_filename.startswith("<frozen importlib")
                    for g in _stack(f))
                by_own[(name, own, importing)] += 1
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        result = step()
    finally:
        stop.set()
        sampler.join()
    return result, {"samples": taken[0], "every_s": every_s, "top": [
        {"thread": k[0], "frame": k[1], "caller": k[2], "repo_frame": k[3],
         "samples": n} for k, n in hits.most_common(top)], "by_repo_frame": [
        {"thread": k[0], "repo_frame": k[1], "importing": k[2],
         "samples": n}
        for k, n in by_own.most_common(top)]}


def _stack(f):
    while f is not None:
        yield f
        f = f.f_back


@contextlib.contextmanager
def collective_seconds():
    """Inside the ``with``, every ``torch.distributed`` call of
    ``parallel/comm.py`` adds its host seconds to the dict it yields, by
    the call's name (a ring shift is an all_gather; a gloo collective on
    CUDA tensors waits for its data, so the device work before it and the
    other ranks' arrival are in its seconds)."""
    from quip_for_all_tpu_torch.parallel import comm
    acc = {}
    real = comm.dist

    class Timed:
        def __getattr__(self, name):
            f = getattr(real, name)
            if not callable(f) or name.startswith("get_"):
                return f

            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
            return call
    comm.dist = Timed()
    try:
        yield acc
    finally:
        comm.dist = real


def warm_grad_imports() -> bool:
    """Import what torch imports at the first backward given an explicit
    gradient (``torch.autograd.grad(..., grad_outputs)``: the pipeline's
    backward), ``torch.fx.experimental.symbolic_shapes`` and with it
    sympy, ~1.5 s a rank (``--profile-ft``'s samples on an NVIDIA H100
    80GB HBM3 machine, 700 W): the one-rank step (``loss.backward()`` of
    a scalar) never takes that path, and a rank that pays it inside its
    first pipelined step stalls the other in the step's shifts. Returns
    whether sympy was loaded before."""
    loaded = "sympy" in sys.modules
    import torch.fx.experimental.symbolic_shapes  # noqa: F401
    return loaded


def alloc_retries() -> int:
    """The caching allocator's retries so far in this process: a
    cudaMalloc that failed, every cached block freed (cudaFree, which
    synchronizes the device) and the allocation tried again."""
    import torch
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def profiled(step):
    """``step()`` (an ``ft_step``) under ``torch.profiler``
    (``chip_smoke.py --phase 21 --profile-ft``). Returns its result and a
    summary: its host ms, the allocator's retries and the free device
    memory before it, the calls of the matmul, allocator and sync ops, the
    device time in all and the ops that take the most device and host
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    free = torch.cuda.mem_get_info()[0] / 2**30
    retries = alloc_retries()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = step()
    loss, ms = result[0], result[2]
    ka = prof.key_averages()

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    def top(key, n=12):
        return [{"op": e.key, "calls": e.count,
                 "self_device_ms": dev_ms(e),
                 "self_host_ms": e.self_cpu_time_total / 1e3}
                for e in sorted(ka, key=key, reverse=True)[:n]]
    calls = {e.key: e.count for e in ka}
    out = {"ms": ms, "loss": loss, "free_gib_before": free,
           "alloc_retries": alloc_retries() - retries,
           "device_ms": sum(dev_ms(e) for e in ka),
           "calls": {k: calls.get(k, 0) for k in (
               "aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
               "aten::linear", "cudaMalloc", "cudaFree",
               "cudaDeviceSynchronize", "cudaStreamSynchronize",
               "cudaMemcpyAsync")},
           "top_device": top(dev_ms),
           "top_host": top(lambda e: e.self_cpu_time_total)}
    return result, out


def check_sp_pp(ref, rs, out_dir):
    """Phase 21's sequence-parallel and pipelined paths on the ranks
    against the one-rank references (``sp_pp_refs``): logits within 1e-4
    of max|logit| plus one ulp, the perplexities equal on the ranks and
    within 1e-4 of the one-rank value (relative), the finetune losses
    within 1e-4 (relative) and every leaf's gradient within 1e-4 of its
    max|grad|, each stage's leaves on its own rank; exact launch counts.
    Returns the summary."""
    import numpy as np

    def tol(a):
        return 1e-4 * np.abs(a).max() + np.spacing(np.abs(a).astype(
            np.float32))
    per = SP_S // TP
    ppl = [r["sp_ppl"] for r in rs]
    if len(set(ppl)) != 1 or abs(ppl[0] - ref["sp_ppl"]) > 1e-4 * ref[
            "sp_ppl"]:
        raise AssertionError(f"sp: the ranks' perplexities {ppl}, the one-"
                             f"rank model's {ref['sp_ppl']}")
    out = {"sp_ppl": ppl[0], "one_rank_sp_ppl": ref["sp_ppl"],
           "one_rank_sp_launches": ref["sp_launches"],
           "one_rank_sp_window_s": ref["sp_window_s"],
           "one_rank_pp_launches": ref["pp_launches"]}
    want = {"sp_logits": {"fused_decode_matmul_tc": SP_K2},
            "sp_perplexity": {"fused_decode_matmul_tc": SP_K2 * SP_WINDOWS},
            "pp_logits": {"fused_decode_matmul_tc": PP_K2},
            "ft": {},
            "ft_kernels": {"fused_decode_matmul_tc": PP_K2,
                           "fused_decode_matmul_bwd": PP_K2}}
    # the one-rank runs: 2048 rows take the dense route, 1024 run K2 (and
    # K3 backward through the kernels); the training forward runs none
    one_rank = {"sp_launches": {},
                "pp_launches": {"fused_decode_matmul_tc": SP_K2},
                "ft": {},
                "ft_kernels": {"fused_decode_matmul_tc": SP_K2,
                               "fused_decode_matmul_bwd": SP_K2}}
    for k, w in one_rank.items():
        got = ref[k]["launches"] if k.startswith("ft") else ref[k]
        if got != w:
            raise AssertionError(f"one-rank {k}: launches {got}, want {w}")
    for r, res in enumerate(rs):
        sp = np.load(os.path.join(out_dir, f"sp{r}.npy"))
        want_sp = ref["sp_logits"][r * per:(r + 1) * per]
        pp = np.load(os.path.join(out_dir, f"pp{r}.npy"))
        errs = {"sp": (sp, want_sp), "pp": (pp, ref["pp_logits"])}
        for name, (got, w) in errs.items():
            err = np.abs(got - w)
            if got.shape != w.shape or not np.all(err <= tol(w)):
                raise AssertionError(f"{name} rank {r}: f32 logits off the "
                                     f"one-rank model's by {err.max():.3g} "
                                     f"(max|logit| {np.abs(w).max():.3g})")
            out[f"rank{r}_{name}_max_err"] = float(err.max())
            out[f"rank{r}_{name}_max_logit"] = float(np.abs(w).max())
        for run, launches in want.items():
            if res[run]["launches"] != launches:
                raise AssertionError(f"rank {r} {run}: launches "
                                     f"{res[run]['launches']}, want "
                                     f"{launches}")
        for kind in ("ft", "ft_kernels"):
            a, b = res[kind]["loss"], ref[kind]["loss"]
            if not abs(a - b) <= 1e-4 * abs(b):
                raise AssertionError(f"{kind} rank {r}: loss {a}, the one-"
                                     f"rank step's {b}")
            got = res[kind]["grads"]
            stage = range(r * LAYERS // TP, (r + 1) * LAYERS // TP)
            mine = sorted(k for k in ref[kind]["grads"]
                          if int(k.split(".", 2)[1]) in stage)
            if sorted(got) != mine:
                raise AssertionError(f"{kind} rank {r}: gradients of "
                                     f"{len(got)} leaves, want {len(mine)}")
            worst = max((float((got[k] - ref[kind]["grads"][k]).abs().max()
                               / ref[kind]["grads"][k].abs().max()), k)
                        for k in mine)
            if not worst[0] <= 1e-4:
                raise AssertionError(f"{kind} rank {r}: gradient {worst[1]} "
                                     f"off the one-rank step's by "
                                     f"{worst[0]:.3g} of its max")
            out[f"rank{r}_{kind}"] = {
                "loss": a, "one_rank_loss": b, "leaves": len(mine),
                "worst_grad_err": worst[0], "worst_leaf": worst[1],
                "step_ms": res[kind]["ms"], "one_rank_step_ms":
                ref[kind]["ms"]}
        out[f"rank{r}_runs"] = {
            k: {f: v[f] for f in ("s", "launches", "collectives",
                                  "collective_s", "peak_gib",
                                  "free_gib_before", "alloc_retries")}
            for k, v in res.items() if isinstance(v, dict) and "s" in v}
        for key in ("ft_profile", "ft_samples"):
            if key in res:
                out[f"rank{r}_{key}"] = res[key]
    out["one_rank_ft"] = {k: {f: ref[k][f] for f in (
        "loss", "ms", "launches", "peak_gib", "free_gib_before",
        "alloc_retries")} for k in ("ft", "ft_kernels")}
    if "ft_profile" in ref:
        out["one_rank_ft_profile"] = ref["ft_profile"]
    return out


def tp_rank(rank, world, init_file, out_dir, profile=False):
    """One rank of phase 21 (spawned): its model of Llama-2-7B from
    ``shard_params``, the kernel checks at its shapes, then, with every
    launch count and collective count set to 0 before each and read after,
    the f32 logits, the greedy bf16 tokens and the f32 serving run; its
    results into ``out_dir``."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    global tm
    from quip_for_all_tpu_torch.tools import _timing as tm
    from quip_for_all_tpu_torch.models.config import llama2_7b_config
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sharding import (make_mesh,
                                                          shard_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(dp=1, tp=world)
        cfg = llama2_7b_config()
        t = time.time()
        unfused, whole = tp_model(cfg)
        model = shard_params(cfg, whole, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        res = {"build_s": time.time() - t, "plane_bytes": sum(
            b.numel() * b.element_size() for n, b in model.named_buffers()
            if "planes_" in n)}
        res["kernel_errs"] = tp_kernel_checks(cfg, model)
        ids, reqs = tp_inputs(cfg)
        for run, fn in (("f32", lambda: tp_f32_logits(cfg, model, ids)),
                        ("greedy", lambda: tp_greedy(cfg, model, ids)),
                        ("serving", lambda: tp_serve(cfg, model, reqs,
                                                     mesh))):
            reset_launches()
            comm.reset_counts()
            torch.cuda.synchronize()
            t = time.time()
            res[run] = fn()
            torch.cuda.synchronize()
            res[f"{run}_s"] = time.time() - t
            res[f"{run}_launches"] = {k: v for k, v in
                                      read_launches().items() if v}
            res[f"{run}_collectives"] = comm.counts()
        res["step_ms"] = tp_step_ms(cfg, model)
        res["step_ms_stub"] = tp_step_ms(cfg, model, stub=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        res["sympy_loaded"] = warm_grad_imports()
        res.update(sp_pp_rank(cfg, unfused, whole, out_dir, rank, profile))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_tp(profile=False):
    """21: Llama-2-7B E8P12 nibble at full width and depth as two tensor-
    parallel ranks on the one card (module docstring); with ``profile``,
    the quantizer's finetune step under the profiler (one rank's second
    call; each pipelined rank's second, its first under a host stack
    sampler: ``sp_pp_rank``)."""
    import gc
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from quip_for_all_tpu_torch.models.config import llama2_7b_config
    cfg = llama2_7b_config()
    ids, reqs = tp_inputs(cfg)
    # the one-rank references, on the whole model
    unfused, model = tp_model(cfg)
    ref_f32 = tp_f32_logits(cfg, model, ids)
    ref_greedy, ref_ms = tp_greedy(cfg, model, ids)
    ref_serve = tp_serve(cfg, model, reqs)
    whole_bytes = sum(b.numel() * b.element_size()
                      for n, b in model.named_buffers() if "planes_" in n)
    sp_ref_sympy = "sympy" in sys.modules
    t = time.time()
    sp_ref = sp_pp_refs(cfg, unfused, model, profile)
    sp_ref_s = time.time() - t
    sp_kernels = sp_pp_kernel_times(model)
    del unfused
    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="tp_")
    t = time.time()
    # a rank that fails makes spawn raise, and the phase with it
    mp.spawn(tp_rank, args=(TP, os.path.join(out, "pg"), out, profile),
             nprocs=TP, join=True)
    ranks_s = time.time() - t
    rs = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
          for r in range(TP)]
    fork = tp_fork(cfg, model, ids, ref_greedy, rs[0]["greedy"][0])
    hold_fork("tp", fork)
    if not np.array_equal(rs[1]["greedy"][0], rs[0]["greedy"][0]):
        raise AssertionError("tp: the ranks' greedy bf16 tokens differ")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tol = 1e-4 * np.abs(ref_f32).max() + np.spacing(
        np.abs(ref_f32).astype(np.float32))
    per_forward = LAYERS * 4 + 1
    summary = {"ranks": TP, "ranks_wall_s": ranks_s,
               "whole_plane_bytes": whole_bytes,
               "one_rank_graphed_ms_token": ref_ms}
    for r, res in enumerate(rs):
        err = np.abs(res["f32"] - ref_f32)
        if not np.all(err <= tol):
            raise AssertionError(f"tp rank {r}: f32 logits off the one-rank "
                                 f"model's by {err.max():.3g} (max|logit| "
                                 f"{np.abs(ref_f32).max():.3g})")
        toks, ms_tok = res["greedy"]
        agree = int(np.sum(toks == ref_greedy))
        outs, chunks, steps = res["serving"]
        same = sum(int(np.array_equal(a, b)) for a, b in zip(outs,
                                                              ref_serve[0]))
        if same != len(reqs):
            raise AssertionError(f"tp rank {r}: {same}/{len(reqs)} f32 "
                                 "served requests equal the one-rank "
                                 "engine's")
        forwards = {"f32": 1 + TP_STEPS, "greedy": TP_GREEDY}
        for run, n in forwards.items():
            got = res[f"{run}_launches"]
            if got != {"fused_decode_matmul": per_forward * n}:
                raise AssertionError(f"tp rank {r} {run}: launches {got}, "
                                     f"want {per_forward * n} K1")
        want = {"fused_decode_matmul": per_forward * steps,
                "fused_decode_matmul_tc": per_forward * chunks}
        if res["serving_launches"] != want:
            raise AssertionError(f"tp rank {r} serving: launches "
                                 f"{res['serving_launches']}, want {want}")
        col = res["greedy_collectives"]
        summary[f"rank{r}"] = {
            "plane_bytes": res["plane_bytes"], "build_s": res["build_s"],
            "kernel_max_err": max(res["kernel_errs"].values()),
            "f32_max_err": float(err.max()),
            "f32_max_logit": float(np.abs(ref_f32).max()),
            "greedy_bf16_agree": agree, "eager_ms_token": ms_tok,
            "k1_a_token": res["greedy_launches"]["fused_decode_matmul"]
            // TP_GREEDY,
            "all_reduce_a_token": col["all_reduce"] / TP_GREEDY,
            "all_gather_a_token": col["all_gather"] / TP_GREEDY,
            "broadcast_a_token": col["broadcast"] / TP_GREEDY,
            "serving_launches": res["serving_launches"],
            "serving_collectives": res["serving_collectives"],
            "serving_prefill_chunks": chunks, "serving_decode_steps": steps,
            "f32_s": res["f32_s"], "greedy_s": res["greedy_s"],
            "serving_s": res["serving_s"], "step_ms": res["step_ms"],
            "step_ms_without_collectives": res["step_ms_stub"],
            "greedy_fork": fork}
        for key, e in res["kernel_errs"].items():
            log(f"tp rank {r}: kernel {key}: max|k-plain| {e:.3g} (tol 1 "
                "bf16 ulp + 1e-5 max)")
        log(f"tp rank {r}: {res['plane_bytes'] / 2**30:.3f} GiB of planes "
            f"(the whole model {whole_bytes / 2**30:.3f}); f32 logits of a "
            f"{TP_PROMPT}-token prefill and {TP_STEPS} cached steps within "
            f"{err.max():.3g} of the one-rank model's (max|logit| "
            f"{np.abs(ref_f32).max():.3g}, tol 1e-4 of it + 1 ulp); "
            f"{agree}/{TP_GREEDY} greedy bf16 tokens as the one-rank run's; "
            f"eager {ms_tok:.1f} ms a token (the one-rank graphed generate "
            f"{ref_ms:.1f}); a token: {summary[f'rank{r}']['k1_a_token']} "
            f"K1, {col['all_reduce'] / TP_GREEDY:.1f} all_reduce, "
            f"{col['all_gather'] / TP_GREEDY:.1f} all_gather, "
            f"{col['broadcast'] / TP_GREEDY:.1f} broadcast; an eager decode "
            f"step {res['step_ms']:.1f} ms, {res['step_ms_stub']:.1f} with "
            f"its collectives stubbed out; f32 serving: {same}/{len(reqs)} "
            f"requests equal the one-rank engine's, {chunks} prefill chunks "
            f"({want['fused_decode_matmul_tc']} K2), {steps} decode steps "
            f"({want['fused_decode_matmul']} K1)")
    summary["sp_pp"] = sp_pp = check_sp_pp(sp_ref, rs, out)
    summary["sp_pp"]["one_rank_refs_s"] = sp_ref_s
    summary["sp_pp"]["sympy_loaded_before"] = {
        "one_rank": sp_ref_sympy,
        **{f"rank{r}": res["sympy_loaded"] for r, res in enumerate(rs)}}
    summary["sp_pp"]["kernels"] = sp_kernels
    log_sp_pp(sp_pp)
    if fork is not None:
        log(f"tp: the ranks' greedy bf16 tokens leave the one-rank run's "
            f"at token {fork['position']}, where the one-rank model's top "
            f"logit is {fork['gap']:.4g} above the rank's token's (one "
            f"bf16 step there: {fork['bf16_step']:.4g})")
    log(f"tp: two ranks on one card (gloo, both on cuda:0) measure the "
        f"sharded path's correctness and launches, not tensor-parallel "
        f"speed; card {smi_line()}; ranks' wall {ranks_s:.1f} s")
    return summary


def log_sp_pp(sp):
    """Phase 21's sequence-parallel and pipelined lines (``check_sp_pp``'s
    summary)."""
    for r in range(TP):
        runs = sp[f"rank{r}_runs"]
        for name, v in runs.items():
            log(f"sp/pp rank {r} {name}: {v['s']:.2f} s, launches "
                f"{v['launches']}, collectives "
                f"{ {k: c for k, c in v['collectives'].items() if c} } "
                f"taking {sum(v['collective_s'].values()):.2f} s, "
                f"peak {v['peak_gib']:.2f} GiB, "
                f"{v['free_gib_before']:.2f} GiB free on the card before "
                f"it, {v['alloc_retries']} allocator retries")
        log(f"sp rank {r}: window 0's f32 logits ({SP_S // TP} rows a rank) "
            f"within "
            f"{sp[f'rank{r}_sp_max_err']:.3g} of the one-rank model's "
            f"(max|logit| {sp[f'rank{r}_sp_max_logit']:.3g}, tol 1e-4 of it "
            f"+ 1 ulp); {runs['sp_perplexity']['s'] / SP_WINDOWS:.2f} s a "
            f"{SP_S}-token window through perplexity(sp_mesh=)")
        log(f"pp rank {r}: f32 logits of {PP_B} x {PP_S} ids in {PP_M} "
            f"microbatches within {sp[f'rank{r}_pp_max_err']:.3g} of the "
            f"one-rank model's (max|logit| "
            f"{sp[f'rank{r}_pp_max_logit']:.3g})")
        for kind in ("ft", "ft_kernels"):
            f = sp[f"rank{r}_{kind}"]
            log(f"{kind} rank {r}: pipelined step loss {f['loss']:.7g} (one "
                f"rank {f['one_rank_loss']:.7g}); {f['leaves']} leaves of "
                f"its stage, worst gradient {f['worst_grad_err']:.3g} of "
                f"its max|grad| ({f['worst_leaf']}; tol 1e-4); forward + "
                f"backward {f['step_ms']:.1f} ms (one rank "
                f"{f['one_rank_step_ms']:.1f})")
    log(f"sp: perplexity {sp['sp_ppl']!r} on both ranks, one rank "
        f"{sp['one_rank_sp_ppl']!r} (dense route at {SP_S} rows: "
        f"launches {sp['one_rank_sp_launches']}, "
        f"{sp['one_rank_sp_window_s']:.2f} s a window); pp one-rank "
        f"launches {sp['one_rank_pp_launches']}; one-rank finetune steps "
        + json.dumps(sp["one_rank_ft"]) + f"; sympy (torch's first "
        f"explicit-gradient backward imports it) loaded before the runs: "
        f"{sp['sympy_loaded_before']}; card {smi_line()}")
    for key in [f"rank{r}_ft_{k}" for r in range(TP)
                for k in ("samples", "profile")] + ["one_rank_ft_profile"]:
        if key in sp:
            log(f"ft profile {key}: " + json.dumps(sp[key]))


def tp_path_launches(entries, tp):
    """Phase 21's launches beside K1's and K2's entries: each rank's K1
    a token and its serving run's K1 and K2, marked as two ranks on one
    card."""
    by = {e["name"]: e for e in entries}
    r0 = tp["rank0"]
    by["fused_decode_matmul"].setdefault("launches_by_path", {}).update(
        tp2_one_card_rank0_greedy_a_token=r0["k1_a_token"],
        tp2_one_card_rank0_serving=r0["serving_launches"][
            "fused_decode_matmul"])
    runs = tp["sp_pp"]["rank0_runs"]
    by["fused_decode_matmul_tc"].setdefault("launches_by_path", {}).update(
        tp2_one_card_rank0_serving_prefill=r0["serving_launches"][
            "fused_decode_matmul_tc"],
        sp2_one_card_rank0_forward=runs["sp_logits"]["launches"][
            "fused_decode_matmul_tc"],
        pp2_one_card_rank0_forward=runs["pp_logits"]["launches"][
            "fused_decode_matmul_tc"],
        pp2_one_card_rank0_step_through_kernels=runs["ft_kernels"][
            "launches"]["fused_decode_matmul_tc"])
    by["fused_decode_matmul_bwd"].setdefault("launches_by_path", {}).update(
        pp2_one_card_rank0_step_through_kernels=runs["ft_kernels"][
            "launches"]["fused_decode_matmul_bwd"])
    # K2's and K3's sums per forward at the new paths' rows and shapes
    per = tp["sp_pp"]["kernels"]["per_forward"]
    by["fused_decode_matmul_tc"]["per_forward_ms_at"] = {
        f"sp2_f32_m{SP_S // TP}": per[f"K2_m{SP_S // TP}"],
        f"pp2_f32_m{PP_S}": per[f"K2_m{PP_S}"]}
    by["fused_decode_matmul_bwd"]["per_step_ms_at"] = {
        f"pp2_f32_m{PP_S}": per[f"K3_m{PP_S}"]}


# ------------------------------------------------------------ phase 22

# expert parallelism: Mixtral-8x7B E8P12 nibble at full width and
# MIXTRAL_EP_LAYERS layers (depth the only cut) as EP_WORLD gloo ranks on
# the one card, laid out by the hybrid mesh dcn_dp = 1 x ici_ep = EP_EP x
# ici_tp = EP_TP (the JAX dry run's ep x tp = 2 layout): each rank holds
# E / EP_EP = 4 experts whole and half of the heads. The f32 prefill and
# steps and the serving requests are phase 21's (tp_inputs); EP_GREEDY
# greedy bf16 tokens.
MIXTRAL_EP_LAYERS = 8
EP_WORLD, EP_EP, EP_TP = 4, 2, 2
EP_GREEDY = 16
# K4 at a rank's dense-stacked shapes, R = E_local * m rows, m an expert:
# held to its twin on every rank at EP_CHECK_M, timed (and held) in this
# process at EP_TIME_M on layer 0's first E_local experts (a rank's)
EP_CHECK_M = (1, 32)
EP_TIME_M = (1, 32, 1024)


def ep_model(cfg):
    """Mixtral-8x7B E8P12 nibble, random codes from seed 0, experts
    stacked, fused qkv, quantized head (phase 6's options)."""
    import torch
    import quip_for_all_tpu_torch as qt
    return qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, seed=0, dtype=torch.bfloat16, quantize_head=True,
        device="cuda"))


def ep_k4_case(E, Gp, G, m, gen):
    """K4's inputs at a rank's dense-stacked shape: x (R = E m, 8 Gp) bf16
    with zero pad lanes, and the expert ids arange(E).repeat_interleave(m)
    (int32), as ``moe_dense_stacked_apply`` makes them."""
    import torch
    R = E * m
    x = torch.zeros((R, 8, Gp), device="cuda")
    x[:, :, :G] = torch.randn((R, 8, G), generator=gen, device="cuda")
    eids = torch.arange(E, dtype=torch.int32,
                        device="cuda").repeat_interleave(m)
    return x.reshape(R, 8 * Gp).to(torch.bfloat16), eids


def ep_check(tag, x, eids, planes, affine, m):
    """K4 against its plain twin (1 bf16 ulp + 1e-5 of the max); returns
    the max error, raising beyond the tolerance."""
    import torch
    from quip_for_all_tpu_torch.ops import moe_matmul as mm
    got = mm.moe_fused_matmul(x, eids, planes, affine, m)
    want = mm.moe_fused_matmul_ref(x, eids, planes, affine)
    torch.cuda.synchronize()
    ok, err = tm.compare(got, want, bf16_step=True)[:2]
    if not ok:
        raise AssertionError(f"ep {tag}: kernel vs plain twin beyond "
                             f"tolerance (max |diff| {err})")
    return err


def ep_kernel_checks(model):
    """On a rank's model: K4 against its plain twin on layer 0's stacked
    w13 and w2 (the rank's E_local experts) at R = E_local * m, m in
    EP_CHECK_M. Returns {case: max error}."""
    import torch
    from quip_for_all_tpu_torch.ops.qtensor import decode_affine
    gen = torch.Generator(device="cuda").manual_seed(22)
    errs = {}
    st = model.layers[0]["block_sparse_moe"]["experts_stacked"]
    for name in ("w13", "w2"):
        sq = st[name]
        planes = sq.plane_list()
        affine = decode_affine(sq.codebook_id, sq.opt_resid_scale)
        Gp = planes[0].shape[-1]
        for m in EP_CHECK_M:
            x, eids = ep_k4_case(sq.E, Gp, sq.q_in // 8, m, gen)
            key = f"K4 {name} {sq.q_out_total}x{Gp} E={sq.E} m={m}"
            errs[key] = ep_check(key, x, eids, planes, affine, m)
    return errs


def ep_k4_times(model):
    """K4 at a rank's dense-stacked shapes, timed: layer 0's experts [0,
    E_local) of the whole model (ep index 0's), R = E_local * m for m in
    EP_TIME_M, held to its twin, then timed by CUDA-graph replays (the
    experts' planes, 117-235 MB, pass through the 50 MB L2 on every call)
    beside its twin, its bound and one library call of the same function
    (``torch.bmm`` on the experts' weights decoded beforehand in bf16).
    Returns one row a (linear, m)."""
    import torch
    from quip_for_all_tpu_torch.ops import moe_matmul as mm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.ops.qtensor import (QuantizedTensor,
                                                    decode_affine)
    gen = torch.Generator(device="cuda").manual_seed(23)
    st = model.layers[0]["block_sparse_moe"]["experts_stacked"]
    E = st["w13"].E // EP_EP
    rows = []
    for name in ("w13", "w2"):
        sq = st[name]
        planes = [p[:E].contiguous() for p in sq.plane_list()]
        affine = decode_affine(sq.codebook_id, sq.opt_resid_scale)
        q_out, q_in, Gp = sq.q_out_total, sq.q_in, planes[0].shape[-1]
        G = q_in // 8
        W = torch.stack([decode_weights(QuantizedTensor(
            {f"w{i}": p[e] for i, p in enumerate(planes)}, sq.codebook_id,
            q_out, q_in, sq.opt_resid_scale), dtype=torch.bfloat16)
            for e in range(E)]).transpose(1, 2)       # (E, q_in, q_out)
        for m in EP_TIME_M:
            x, eids = ep_k4_case(E, Gp, G, m, gen)
            R = E * m
            err = ep_check(f"K4 {name} m={m} (timed)", x, eids, planes,
                           affine, m)
            n = 2 if m >= 256 else 8
            k_ms = 1e-3 * tm.graph_us(lambda i: mm.moe_fused_matmul(
                x, eids, planes, affine, m), n)
            p_ms = 1e-3 * tm.event_us(lambda i: mm.moe_fused_matmul_ref(
                x, eids, planes, affine), 2)
            xn = x.reshape(R, 8, Gp)[:, :, :G].transpose(1, 2).reshape(
                E, m, q_in).contiguous()
            lib_ms = 1e-3 * tm.graph_us(lambda i: torch.bmm(xn, W), n)
            nbytes = (E * q_out * Gp * 4 * len(planes) + R * 8 * Gp * 2
                      + R * q_out * 2 + R * 4)
            b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
            b_ops = 2 * R * q_out * q_in / tm.BF16_OPS_PER_S * 1e3
            row = {"layer": name, "q_out": q_out, "Gp": Gp, "experts": E,
                   "m": m, "R": R, "max_abs_err": err, "ms": k_ms,
                   "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                   "bytes": nbytes}
            rows.append(row)
            log(f"kernel moe (ep) {name:3s} {q_out}x{Gp} E={E} m={m:4d} "
                f"R={R:4d}: max|k-plain| {err:.3g} (tol 1 bf16 ulp + 1e-5 "
                f"max) | kernel {k_ms * 1e3:.1f} us | plain "
                f"{p_ms * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.1f} us "
                f"({row['bound_by']}) | {row['bound_ms'] / k_ms:.0%} of "
                f"bound | library {lib_ms * 1e3:.1f} us (torch.bmm on the "
                f"{E} experts' bf16 weights)")
        del W
        torch.cuda.empty_cache()
    return rows


def ep_runs(cfg, model, ids, reqs, mesh=None):
    """The phase's three runs on a model, with the launch and collective
    counts set to 0 before each and read after: the f32 prefill and
    steps, the greedy bf16 tokens and the f32 serving run."""
    import torch
    from quip_for_all_tpu_torch.parallel import comm
    res = {}
    for run, fn in (("f32", lambda: tp_f32_logits(cfg, model, ids)),
                    ("greedy", lambda: tp_greedy(cfg, model, ids,
                                                 EP_GREEDY)),
                    ("serving", lambda: tp_serve(cfg, model, reqs, mesh))):
        reset_launches()
        comm.reset_counts()
        torch.cuda.synchronize()
        t = time.time()
        res[run] = fn()
        torch.cuda.synchronize()
        res[f"{run}_s"] = time.time() - t
        res[f"{run}_launches"] = {k: v for k, v in read_launches().items()
                                  if v}
        res[f"{run}_collectives"] = {k: v for k, v in comm.counts().items()
                                     if v}
    return res


def ep_rank(rank, out_dir):
    """One rank of phase 22 (spawned; the parent set MASTER_ADDR,
    MASTER_PORT and WORLD_SIZE, and the rank sets RANK, as torchrun sets
    them): ``multihost.initialize``, the hybrid mesh, its model of
    Mixtral-8x7B from ``shard_params``, K4's checks at its shapes, then
    the three runs; its results into ``out_dir``."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    global tm
    from quip_for_all_tpu_torch.tools import _timing as tm
    from quip_for_all_tpu_torch.models.config import mixtral_8x7b_config
    from quip_for_all_tpu_torch.parallel import multihost
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    if multihost.initialize() != rank:
        raise AssertionError(f"ep rank {rank}: initialize joined as another "
                             "rank")
    try:
        mesh = multihost.make_hybrid_mesh(dcn_dp=1, ici_tp=EP_TP,
                                          ici_ep=EP_EP)
        cfg = dataclasses.replace(mixtral_8x7b_config(),
                                  num_hidden_layers=MIXTRAL_EP_LAYERS)
        t = time.time()
        whole = ep_model(cfg)
        model = shard_params(cfg, whole, mesh)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        moe = model.layers[0]["block_sparse_moe"]
        res = {"build_s": time.time() - t, "coords": mesh.coords,
               "topology": multihost.mesh_topology(mesh),
               "moe": type(moe).__name__,
               "experts": (getattr(moe, "offset", 0),
                           moe["experts_stacked"]["w13"].E),
               "plane_bytes": sum(b.numel() * b.element_size() for n, b in
                                  model.named_buffers() if "planes_" in n)}
        res["kernel_errs"] = ep_kernel_checks(model)
        ids, reqs = tp_inputs(cfg)
        res.update(ep_runs(cfg, model, ids, reqs, mesh))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_ep():
    """22: Mixtral-8x7B at full width as four expert- and tensor-parallel
    ranks on the one card (module docstring): the one-rank references and
    K4's times at the ranks' shapes here, then the ranks, each held to
    the references."""
    import gc
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from quip_for_all_tpu_torch.models.config import mixtral_8x7b_config
    from quip_for_all_tpu_torch.parallel.multihost import free_port
    cfg = dataclasses.replace(mixtral_8x7b_config(),
                              num_hidden_layers=MIXTRAL_EP_LAYERS)
    L = cfg.num_hidden_layers
    ids, reqs = tp_inputs(cfg)
    t = time.time()
    model = ep_model(cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t
    whole_bytes = sum(b.numel() * b.element_size()
                      for n, b in model.named_buffers() if "planes_" in n)
    # the one-rank references: the same runs on the whole model (its
    # 32-token prefill takes the dense expert loop, its steps the sparse
    # route; its greedy generate CUDA graphs)
    ref = ep_runs(cfg, model, ids, reqs)
    k4 = ep_k4_times(model)
    out = tempfile.mkdtemp(prefix="ep_")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      WORLD_SIZE=str(EP_WORLD))
    t = time.time()
    try:
        # a rank that fails makes spawn raise, and the phase with it
        mp.spawn(ep_rank, args=(out,), nprocs=EP_WORLD, join=True)
    finally:
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
            os.environ.pop(k, None)
    ranks_s = time.time() - t
    rs = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
          for r in range(EP_WORLD)]
    ref_greedy = ref["greedy"][0]
    forks = [tp_fork(cfg, model, ids, ref_greedy, res["greedy"][0])
             for res in rs]
    for r, (res, fork) in enumerate(zip(rs, forks)):
        hold_fork(f"ep rank {r}", fork)
        if not np.array_equal(res["greedy"][0], rs[0]["greedy"][0]):
            raise AssertionError(f"ep rank {r}: greedy bf16 tokens differ "
                                 "from rank 0's")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ref_f32 = ref["f32"]
    tol = 1e-4 * np.abs(ref_f32).max() + np.spacing(
        np.abs(ref_f32).astype(np.float32))
    k1, k4n = 2 * L + 1, 2 * L       # a forward: qkv, o, head; w13, w2
    summary = {"ranks": EP_WORLD, "layers": L, "ranks_wall_s": ranks_s,
               "one_rank_build_s": build_s,
               "whole_plane_bytes": whole_bytes,
               "one_rank": {k: v for k, v in ref.items()
                            if k not in ("f32", "greedy", "serving")},
               "one_rank_graphed_ms_token": ref["greedy"][1],
               "k4_times": k4}
    E = cfg.num_local_experts // EP_EP
    for r, res in enumerate(rs):
        d, e, tpi = res["coords"]
        if (res["moe"], res["experts"]) != ("ExpertParallelMoE",
                                             (e * E, E)):
            raise AssertionError(f"ep rank {r}: MoE {res['moe']} with "
                                 f"experts {res['experts']}, want "
                                 f"ExpertParallelMoE with {(e * E, E)}")
        err = np.abs(res["f32"] - ref_f32)
        if not np.all(err <= tol):
            raise AssertionError(f"ep rank {r}: f32 logits off the one-rank "
                                 f"model's by {err.max():.3g} (max|logit| "
                                 f"{np.abs(ref_f32).max():.3g})")
        outs, chunks, steps = res["serving"]
        same = sum(int(np.array_equal(a, b))
                   for a, b in zip(outs, ref["serving"][0]))
        if same != len(reqs):
            raise AssertionError(f"ep rank {r}: {same}/{len(reqs)} f32 "
                                 "served requests equal the one-rank "
                                 "engine's")
        want = {"f32": {"fused_decode_matmul": k1 * (1 + TP_STEPS),
                        "moe_decode_matmul": k4n * (1 + TP_STEPS)},
                "greedy": {"fused_decode_matmul": k1 * EP_GREEDY,
                           "moe_decode_matmul": k4n * EP_GREEDY},
                "serving": {"fused_decode_matmul": k1 * steps,
                            "fused_decode_matmul_tc": k1 * chunks,
                            "moe_decode_matmul": k4n * (steps + chunks)}}
        for run, w in want.items():
            if res[f"{run}_launches"] != w:
                raise AssertionError(f"ep rank {r} {run}: launches "
                                     f"{res[f'{run}_launches']}, want {w}")
        # a forward: qkv's gather, o's gather and sum, the ep sum (a
        # block), the head's gather
        col = res["greedy_collectives"]
        if (col.get("all_gather"), col.get("all_reduce")) != (
                (2 * L + 1) * EP_GREEDY, 2 * L * EP_GREEDY):
            raise AssertionError(f"ep rank {r}: collectives {col} in "
                                 f"{EP_GREEDY} tokens, want "
                                 f"{2 * L + 1} all_gather and {2 * L} "
                                 "all_reduce a token")
        toks = res["greedy"][0]
        agree = int(np.sum(toks == ref_greedy))
        summary[f"rank{r}"] = {
            "coords": res["coords"], "topology": res["topology"],
            "experts": res["experts"], "plane_bytes": res["plane_bytes"],
            "build_s": res["build_s"],
            "kernel_errs": res["kernel_errs"],
            "f32_max_err": float(err.max()),
            "f32_max_logit": float(np.abs(ref_f32).max()),
            "greedy_bf16_agree": agree, "greedy_fork": forks[r],
            "eager_ms_token": res["greedy"][1],
            "launches": {k: res[f"{k}_launches"] for k in want},
            "collectives": {k: res[f"{k}_collectives"] for k in want},
            "collectives_a_token": {k: v / EP_GREEDY
                                    for k, v in col.items()},
            "serving_prefill_chunks": chunks, "serving_decode_steps": steps,
            "seconds": {k: res[f"{k}_s"] for k in want}}
        for key, kerr in res["kernel_errs"].items():
            log(f"ep rank {r}: kernel {key}: max|k-plain| {kerr:.3g} (tol 1 "
                "bf16 ulp + 1e-5 max)")
        log(f"ep rank {r} at {res['coords']} of {res['topology']}: experts "
            f"[{res['experts'][0]}, {sum(res['experts'])}), "
            f"{res['plane_bytes'] / 2**30:.3f} GiB of planes (the whole "
            f"model {whole_bytes / 2**30:.3f}); f32 logits of a "
            f"{TP_PROMPT}-token prefill and {TP_STEPS} cached steps within "
            f"{err.max():.3g} of the one-rank model's (max|logit| "
            f"{np.abs(ref_f32).max():.3g}, tol 1e-4 of it + 1 ulp); "
            f"{agree}/{EP_GREEDY} greedy bf16 tokens as the one-rank run's; "
            f"eager {res['greedy'][1]:.1f} ms a token (the one-rank graphed "
            f"generate {ref['greedy'][1]:.1f}); a token: {k1} K1, {k4n} K4, "
            + ", ".join(f"{v / EP_GREEDY:.1f} {k}" for k, v in col.items())
            + f"; f32 serving: {same}/{len(reqs)} requests equal the "
            f"one-rank engine's, {chunks} prefill chunks ({k1 * chunks} K2, "
            f"{k4n * chunks} K4 at {4 * 128} rows an expert), {steps} "
            f"decode steps; runs {res['f32_s']:.1f} / {res['greedy_s']:.1f}"
            f" / {res['serving_s']:.1f} s")
        if forks[r] is not None:
            f = forks[r]
            log(f"ep rank {r}: its greedy bf16 tokens leave the one-rank "
                f"run's at token {f['position']}, where the one-rank "
                f"model's top logit is {f['gap']:.4g} above the rank's "
                f"token's (one bf16 step there: {f['bf16_step']:.4g})")
    log(f"ep: {EP_WORLD} ranks on one card (gloo, all on cuda:0) measure "
        f"the expert-parallel path's correctness, launches and "
        f"collectives, not its speed; card {smi_line()}; ranks' wall "
        f"{ranks_s:.1f} s")
    return summary


def ep_path_launches(entries, ep):
    """Phase 22's launches beside K1's, K2's and K4's entries (rank 0's;
    four ranks on one card), and K4's times at a rank's dense-stacked
    shapes."""
    by = {e["name"]: e for e in entries}
    r0 = ep["rank0"]["launches"]
    by["fused_decode_matmul"].setdefault("launches_by_path", {}).update(
        ep2_tp2_one_card_rank0_greedy=r0["greedy"]["fused_decode_matmul"],
        ep2_tp2_one_card_rank0_serving=r0["serving"]["fused_decode_matmul"])
    by["fused_decode_matmul_tc"].setdefault("launches_by_path", {}).update(
        ep2_tp2_one_card_rank0_serving_prefill=r0["serving"][
            "fused_decode_matmul_tc"])
    k4 = by["moe_decode_matmul"]
    k4.setdefault("launches_by_path", {}).update(
        ep2_tp2_one_card_rank0_greedy=r0["greedy"]["moe_decode_matmul"],
        ep2_tp2_one_card_rank0_f32=r0["f32"]["moe_decode_matmul"],
        ep2_tp2_one_card_rank0_serving=r0["serving"]["moe_decode_matmul"])
    k4["dense_stacked_at_4_experts"] = {
        f"{row['layer']}_m{row['m']}": {k: row[k] for k in (
            "R", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")} for row in ep["k4_times"]}


# ------------------------------------------------------------ phases 23, 25

# training under a mesh, two phases of one harness (``TrainPhase``; all in
# f32, each rank held to the one-rank step within TRAIN_TOL): (a) one
# end-to-end finetune step (the training forward: calc_weight's dense W,
# no kernel), each dp rank its part; (b) one LoRA step, the whole batch on
# every rank (rank 8, the default targets, AdamW at TRAIN_LORA_LR; K2
# forward, K3 backward at the rank-local shapes), adapters added after
# shard_params. TRAIN_WORLD gloo ranks on cuda:0.
#
# Phase 23, a ("dp", "tp") mesh: Llama-2-7B E8P12 nibble at full width and
# PHASE23_LAYERS layers (depth the only cut, for the script's time),
# random codes from seed 0, q/k/v/o/gate/up/down unfused, the head
# quantized, with phase 21's tp_shards = 2 transforms, at make_mesh(dp=2,
# tp=2); (a) on 4 x TRAIN_S ids, (b) on 2 x TRAIN_S (1022 rows).
#
# Phase 25, the expert axis: Mixtral-8x7B E8P12 nibble at full width and
# MIXTRAL_TRAIN_LAYERS layers (depth the only cut), random codes from seed
# 0, experts stacked, attention unfused, whole transforms, the head
# quantized, at make_mesh(ep=2, tp=2) (phase 22's layout: each rank 4
# experts whole, half of the heads); (a) on 2 x TRAIN_S ids and the first
# MIXTRAL_FT_LAYERS blocks, (b) on 1 x TRAIN_S (511 rows). A rank's
# forward that autograd differentiates takes the dense expert loop over
# its own experts (``ExpertParallelMoE``), through K2 in (b). (a)'s
# depth cut: its backward keeps each expert linear's dense f32 W (0.22
# GiB), and four ranks at 4 layers (17.88 GiB each at their peak)
# exhausted the card's 76.8 GiB free when the whole script ran (P22c).
PHASE23_LAYERS = 8
MIXTRAL_TRAIN_LAYERS = 4
MIXTRAL_FT_LAYERS = 2
TRAIN_WORLD = 4
TRAIN_S = 512
TRAIN_LRS = (5e-4, 5e-5)            # SU/SV, the rest
TRAIN_LORA_LR = 1e-4
TRAIN_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class TrainPhase:
    """What phases 23 and 25 set. ``layers``: the model's depth, and
    ``ft_layers`` the blocks (a) runs on (its first); ``shapes``: a
    rank's K2/K3 checks, (name, its linear in block 0 (``train_linear``),
    or None for the head; q_out, q_in of the rank's planes); ``experts``:
    the experts a rank runs a block (0 without them); ``one_launches``:
    (b)'s (K2, K3) on one rank (a rank's follow from ``shapes``,
    ``train_calls``); ``collectives``: (leaves, (a)'s layers, layers) ->
    the predicted count a rank's step by kind, logged beside the count;
    ``rank_key``: the kernels line's key of its K2/K3 rows."""
    label: str
    cfg: Callable
    model: Callable
    layers: int
    ft_layers: int
    mesh: dict
    ft_b: int
    lora_b: int
    shapes: tuple
    experts: int
    one_launches: tuple
    collectives: Callable
    rank_key: str


def train_cfg():
    import dataclasses as dc
    from quip_for_all_tpu_torch.models.config import llama2_7b_config
    return dc.replace(llama2_7b_config(), num_hidden_layers=PHASE23_LAYERS)


def train_model(cfg):
    """Phase 23's model (above), its trainable leaves in f32."""
    import torch
    import quip_for_all_tpu_torch as qt
    return tp_block_diagonal(qt.random_quantized_model(
        cfg, seed=0, dtype=torch.float32, quantize_head=True,
        device="cuda"), 2)


def mix_train_cfg():
    import dataclasses as dc
    from quip_for_all_tpu_torch.models.config import mixtral_8x7b_config
    return dc.replace(mixtral_8x7b_config(),
                      num_hidden_layers=MIXTRAL_TRAIN_LAYERS)


def mix_train_model(cfg):
    """Phase 25's model (above), its trainable leaves in f32."""
    import torch
    import quip_for_all_tpu_torch as qt
    return qt.random_quantized_model(cfg, seed=0, dtype=torch.float32,
                                     quantize_head=True, device="cuda")


def train_calls(ph, kernel, name):
    """A linear's calls in a rank's (b) forward: once a block, an expert
    linear once for each of the rank's experts, the head once; K3 less
    layer 0's q, k and v, whose input needs no gradient."""
    if name == "head":
        return 1
    if kernel == "K3" and name in ("q", "k", "v"):
        return ph.layers - 1
    return ph.layers * (ph.experts if name in ("w1", "w3", "w2") else 1)


def rank_launches(ph):
    """(b)'s (K2, K3) a rank: ``train_calls`` over the rank's linears."""
    return tuple(sum(train_calls(ph, kernel, name) for name, *_ in
                     ph.shapes) for kernel in ("K2", "K3"))


def _llama_collectives(leaves, F, L):
    """(a) the row sums (2 a block) and the head's gather forward, a
    column shard's input gradient summed (5 a block, the head) backward,
    the dp mean of the loss and every leaf; (b) the row sums and the row
    adapters' (m, r) sums forward, the column shards' input sums (less
    layer 0's q, k, v), the column adapters' h and B and the row
    adapters' A backward."""
    return {"ft": {"all_reduce": 7 * F + 2 + leaves, "all_gather": 1},
            "lora": {"all_reduce": 21 * L - 2, "all_gather": 1}}


def _mix_collectives(leaves, F, L):
    """(a) a block gathers q's, k's, v's outputs and o's input (the whole
    transforms' gather route) and sums o's partials and its experts'
    partial forward, and sums the gradients at q's, k's, v's inputs and
    outputs and at o's input (tp) and at the router's logits and the
    MoE's input (ep) backward; the head gathers its logits and sums its
    input's gradient; dp 1: no mean. (b) the same gathers, and o's
    adapter's (m, r) partial summed forward; backward, no sum at layer
    0's q/k/v input and outputs (nothing before them takes a gradient),
    two a column adapter (its h and B) and one for o's A."""
    return {"ft": {"all_reduce": 11 * F + 1, "all_gather": 4 * F + 1},
            "lora": {"all_reduce": 19 * L - 5, "all_gather": 4 * L + 1}}


TRAIN_PHASES = {
    "23": TrainPhase(
        label="train", cfg=train_cfg, model=train_model,
        layers=PHASE23_LAYERS, ft_layers=PHASE23_LAYERS,
        mesh={"dp": 2, "tp": 2}, ft_b=4, lora_b=2,
        shapes=(("q", ("self_attn", "q_proj"), 2048, 4096),
                ("k", ("self_attn", "k_proj"), 2048, 4096),
                ("v", ("self_attn", "v_proj"), 2048, 4096),
                ("o", ("self_attn", "o_proj"), 4096, 2048),
                ("gate", ("mlp", "gate_proj"), 5504, 4096),
                ("up", ("mlp", "up_proj"), 5504, 4096),
                ("down", ("mlp", "down_proj"), 4096, 5504),
                ("head", None, 16000, 4096)),
        # K2 on every quantized linear (7 a block, the head), at whole
        # widths on one rank and the rank-local ones on each rank
        experts=0,
        one_launches=(7 * PHASE23_LAYERS + 1, 7 * PHASE23_LAYERS - 2),
        collectives=_llama_collectives, rank_key="rank_local_f32"),
    "25": TrainPhase(
        label="ep train", cfg=mix_train_cfg, model=mix_train_model,
        layers=MIXTRAL_TRAIN_LAYERS, ft_layers=MIXTRAL_FT_LAYERS,
        mesh={"dp": 1, "ep": 2, "tp": 2},
        ft_b=2, lora_b=1,
        shapes=(("q", ("self_attn", "q_proj"), 2048, 4096),
                ("k", ("self_attn", "k_proj"), 512, 4096),
                ("v", ("self_attn", "v_proj"), 512, 4096),
                ("o", ("self_attn", "o_proj"), 4096, 2048),
                ("w1", ("experts", "w1"), 14336, 4096),
                ("w3", ("experts", "w3"), 14336, 4096),
                ("w2", ("experts", "w2"), 4096, 14336),
                ("head", None, 16000, 4096)),
        # K2 on q/k/v/o and the experts' w1/w3/w2 (8 experts a block on
        # one rank, a rank's 4) and the head
        experts=4,
        one_launches=(28 * MIXTRAL_TRAIN_LAYERS + 1,
                      28 * MIXTRAL_TRAIN_LAYERS - 2),
        collectives=_mix_collectives, rank_key="ep2_tp2_rank_local_f32"),
}


def train_inputs(cfg, ph):
    """(a)'s ids and next-token targets, (b)'s tokens (seed 23)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(23)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (ph.ft_b, TRAIN_S)), device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (ph.lora_b, TRAIN_S)),
                           device="cuda")
    return ids, torch.roll(ids, -1, dims=1), toks


def train_run(res, name, fn):
    """``fn()`` with every launch and collective count set to 0 before
    and read after; its host s, the collectives' host s by call, the
    peak memory into ``res[name]``."""
    import torch
    from quip_for_all_tpu_torch.parallel import comm
    reset_launches()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with collective_seconds() as coll_s:
        out = fn()
        torch.cuda.synchronize()
    res[name] = {"s": time.perf_counter() - t,
                 "launches": {k: v for k, v in read_launches().items() if v},
                 "collectives": {k: v for k, v in comm.counts().items()
                                 if v},
                 "collective_s": coll_s,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out


def train_steps(ph, cfg, model, mesh=None):
    """(a) and (b) on the whole model or a rank's (with its ``mesh``):
    the losses, gradients (gathered into the JAX package's names) and
    leaves after each step, with ``train_run``'s numbers. (a) runs on the
    model's first ``ph.ft_layers`` blocks, and its leaves go back to their
    values before (b)."""
    import torch
    from torch import nn
    from quip_for_all_tpu_torch.nn.lora import add_lora
    from quip_for_all_tpu_torch.quantize import finetune as FT
    from quip_for_all_tpu_torch.quantize.lora_train import causal_lm_loss
    ids, tgt, toks = train_inputs(cfg, ph)
    res = {}
    fcfg = dataclasses.replace(cfg, num_hidden_layers=ph.ft_layers)
    layers = model.layers
    model.layers = nn.ModuleList(list(layers)[:ph.ft_layers])
    try:
        flat = FT.collect_trainable(model)
        before = FT.freeze(flat)
        FT.apply_trainable(model, flat)
        opt = FT.make_susv_optimizer(*TRAIN_LRS, flat)
        step = FT.make_train_step(
            opt, lambda i: FT.student_logits(fcfg, model, i), mesh=mesh)
        res["ft_loss"] = train_run(res, "ft",
                                   lambda: float(step(ids, tgt)))
        res["ft_leaves"] = len(flat)
        res["ft_grads"] = FT.gather_trainable(model, flat, grads=True)
        res["ft_new"] = FT.gather_trainable(model, flat)
        FT.apply_trainable(model, before)
    finally:
        model.layers = layers
    del flat, opt, step
    torch.cuda.empty_cache()
    add_lora(model, rank=8, alpha=16.0, seed=0)
    lflat = offset_lora_b(model, seed=23)
    # train_lora's optimizer (optax.adamw's defaults, no decay)
    lopt = torch.optim.AdamW(list(lflat.values()), lr=TRAIN_LORA_LR,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    def lstep():
        lopt.zero_grad(set_to_none=True)
        loss = causal_lm_loss(cfg, model, toks, f32_kw())
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in lflat.items()}
        lopt.step()
        return loss.item(), grads
    res["lora_loss"], res["lora_grads"] = train_run(res, "lora", lstep)
    res["lora_new"] = {k: p.detach().clone() for k, p in lflat.items()}
    return res


def train_hold(tag, got, ref, kind):
    """``kind``'s gradients (each within TRAIN_TOL of its max|grad| plus
    one ulp of the one-rank step's) and leaves after the step (within
    TRAIN_TOL of their max plus one ulp where |grad| exceeds the gradient
    tolerance: Adam's first step is +-lr sign(g), so a near-zero
    gradient's may flip); raises beyond. Returns the worst of each, as a
    fraction of the leaf's max, with its leaf."""
    import torch
    eps = torch.finfo(torch.float32).eps
    want_g, want_n = ref[f"{kind}_grads"], ref[f"{kind}_new"]
    if sorted(got[f"{kind}_grads"]) != sorted(want_g):
        raise AssertionError(f"{tag} {kind}: leaves {len(got[f'{kind}_grads'])}"
                             f", the one-rank step's {len(want_g)}")
    worst = {"grad": (0.0, None), "new": (0.0, None)}
    for k, wg in want_g.items():
        wg = wg.cuda().float()
        g = got[f"{kind}_grads"][k].float()
        wn = want_n[k].cuda().float()
        n = got[f"{kind}_new"][k].float()
        if g.shape != wg.shape or n.shape != wn.shape:
            raise AssertionError(f"{tag} {kind} {k}: shape {tuple(g.shape)}"
                                 f", the one-rank step's {tuple(wg.shape)}")
        scale = float(wg.abs().max())
        over = ((g - wg).abs() - eps * wg.abs()).clamp_min(0)
        e = float(over.max()) / scale if scale else float(over.max())
        big = wg.abs() > TRAIN_TOL * scale + eps * wg.abs()
        nscale = float(wn.abs().max())
        nover = ((n - wn).abs() - eps * wn.abs()).clamp_min(0)[big]
        en = (float(nover.max()) / nscale if nover.numel() else 0.0)
        if not (e <= TRAIN_TOL and en <= TRAIN_TOL):
            raise AssertionError(
                f"{tag} {kind} {k}: gradient off the one-rank step's by "
                f"{e:.3g} of its max ({scale:.3g}), the leaf after the step "
                f"by {en:.3g} of its max (tol {TRAIN_TOL})")
        worst["grad"] = max(worst["grad"], (e, k), key=lambda w: w[0])
        worst["new"] = max(worst["new"], (en, k), key=lambda w: w[0])
    return worst


def train_linear(model, path):
    """A rank's quantized linear of block 0 (``path``) or the head: its
    cut ``QuantLinear`` (under its adapter, once (b) has added one), or
    ("experts", name) the view of w1, w3 or w2 of the rank's first
    expert."""
    if path is not None and path[0] == "experts":
        from quip_for_all_tpu_torch.nn.qmoe import unstack_qlinear
        st = model.layers[0]["block_sparse_moe"]["experts_stacked"]
        w1, w3 = unstack_qlinear(st["w13"], 0)
        w2, = unstack_qlinear(st["w2"], 0)
        return {"w1": w1, "w3": w3, "w2": w2}[path[1]]
    lin = model.lm_head if path is None else model.layers[0][path[0]][
        path[1]]
    return getattr(lin, "lora_base", lin).local


def train_kernels(ph, model, timed=False):
    """K2 (f32 x) and K3 (f32 g) at each rank-local shape of (b),
    m = ph.lora_b x (TRAIN_S - 1) rows: one call each against its
    plain twin (1e-5 of max plus one bf16 ulp), and with ``timed`` (one
    rank, the others waiting) timed as phase 21 times them: CUDA-graph
    replays, L2-cold; the twin by events; beside the library product
    (x @ W.T, g @ W with W decoded in f32) and the bound (planes, input
    and output once; 2 m q_out q_in operations three times at the bf16
    tensor-core rate: f32 x or g as three bf16 terms). Returns one row a
    (kernel, linear)."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    gen = torch.Generator(device="cuda").manual_seed(23)
    m = ph.lora_b * (TRAIN_S - 1)
    rows = []
    for name, path, q_out, q_in in ph.shapes:
        qt = train_linear(model, path).qweight
        if (qt.q_out, qt.q_in) != (q_out, q_in):
            raise AssertionError(f"{ph.label} {name}: rank-local planes "
                                 f"{qt.q_out}x{qt.q_in}, want {q_out}x{q_in}")
        planes, affine, Gp = qt.plane_list(), qt.decode_affine, qt.group_cols
        G = q_in // 8
        cp = tm.cold_copies(planes) if timed else [planes]
        W = decode_weights(qt, dtype=torch.float32) if timed else None
        Wc = tm.cold_copies([W]) if timed else None
        nb = sum(w.numel() * 4 for w in planes)
        for kernel in ("K2", "K3"):
            if kernel == "K2":
                x = torch.zeros((m, 8, Gp), device="cuda")
                x[:, :, :G] = torch.randn((m, 8, G), generator=gen,
                                          device="cuda")
                x = x.reshape(m, 8 * Gp)
                x_nat = x.reshape(m, 8, Gp)[:, :, :G].transpose(
                    1, 2).reshape(m, q_in).contiguous()
                got = fm.fused_decode_matmul_tc(x, planes, affine)
                want = fm.fused_decode_matmul_ref(x, planes, affine)

                def run(i):
                    return fm.fused_decode_matmul_tc(x, cp[i % len(cp)],
                                                     affine)

                def plain(i):
                    return fm.fused_decode_matmul_ref(x, cp[i % len(cp)],
                                                      affine)

                def lib(i):
                    return torch.matmul(x_nat, Wc[i % len(Wc)][0].T)
            else:
                x = torch.randn((m, q_out), generator=gen, device="cuda")
                got = fm.fused_decode_matmul_bwd(x, planes, affine, None, G,
                                                 Gp)
                want = fm.fused_decode_matmul_bwd_ref(x, planes, affine,
                                                      None, G, Gp)

                def run(i):
                    return fm.fused_decode_matmul_bwd(
                        x, cp[i % len(cp)], affine, None, G, Gp)

                def plain(i):
                    return fm.fused_decode_matmul_bwd_ref(
                        x, cp[i % len(cp)], affine, None, G, Gp)

                def lib(i):
                    return torch.matmul(x, Wc[i % len(Wc)][0])
            torch.cuda.synchronize()
            ok, err = tm.compare(got, want, bf16_step=True)[:2]
            if not ok:
                raise AssertionError(f"{ph.label} {kernel} {name} m={m} f32:"
                                     f" kernel vs plain twin beyond "
                                     f"tolerance (max |diff| {err})")
            row = {"kernel": kernel, "layer": name, "q_out": q_out,
                   "q_in": q_in, "Gp": Gp, "m": m, "max_abs_err": err}
            if timed:
                nbytes = nb + m * 8 * Gp * 4 + m * q_out * 4
                b_bytes = nbytes / tm.HBM_BYTES_PER_S * 1e3
                b_ops = 2 * m * q_out * q_in / tm.F32_SPLIT_OPS_PER_S * 1e3
                row.update(ms=1e-3 * tm.graph_us(run, 4 * len(cp)),
                           plain_ms=1e-3 * tm.event_us(plain, 2),
                           library_ms=1e-3 * tm.graph_us(lib, 4 * len(Wc)),
                           bound_ms=max(b_bytes, b_ops),
                           bound_by="bytes" if b_bytes >= b_ops
                           else "operations")
                log(f"kernel {ph.label} {kernel} {name:4s} {q_out}x{Gp} "
                    f"m={m} f32 (a rank's): max|k-plain| {err:.3g} | kernel "
                    f"{row['ms'] * 1e3:.1f} us | plain "
                    f"{row['plain_ms'] * 1e3:.1f} us | bound "
                    f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}) | "
                    f"library {row['library_ms'] * 1e3:.1f} us")
            rows.append(row)
            del x, got, want
        del cp, W, Wc
        torch.cuda.empty_cache()
    return rows


def train_sums(ph, rows):
    """K2's ms a rank's LoRA forward and K3's a step: each linear's row
    times its calls (``train_calls``)."""
    return {kernel: {key: sum(r[key] * train_calls(ph, kernel, r["layer"])
                              for r in rows if r["kernel"] == kernel)
                     for key in ("ms", "plain_ms", "library_ms",
                                 "bound_ms")}
            for kernel in ("K2", "K3")}


def train_rank(rank, tag, ref_path, out_dir):
    """One rank of phase ``tag`` (spawned; the parent set MASTER_ADDR,
    MASTER_PORT and WORLD_SIZE, the rank sets RANK, as torchrun sets
    them): ``multihost.initialize``, ``make_mesh`` of the phase, its model
    from ``shard_params``, (a) and (b) held to the one-rank references of
    ``ref_path``, K2/K3 against their twins at its shapes (rank 0 then
    times them, the others waiting); its results into ``out_dir``."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    global tm
    from quip_for_all_tpu_torch.tools import _timing as tm
    from quip_for_all_tpu_torch.parallel import multihost
    from quip_for_all_tpu_torch.parallel.sharding import (make_mesh,
                                                          shard_params)
    ph = TRAIN_PHASES[tag]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    if multihost.initialize() != rank:
        raise AssertionError(f"{ph.label} rank {rank}: initialize joined as "
                             "another rank")
    try:
        mesh = make_mesh(**ph.mesh)
        cfg = ph.cfg()
        t = time.time()
        whole = ph.model(cfg)
        model = shard_params(cfg, whole, mesh)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        res = {"build_s": time.time() - t, "coords": mesh.coords,
               "free_gib": torch.cuda.mem_get_info()[0] / 2**30}
        log(f"{ph.label} rank {rank}: built in {res['build_s']:.1f} s, "
            f"{res['free_gib']:.1f} GiB free on the card")
        # the twins' checks before the steps on the even ranks, as phases
        # 21 and 22 run theirs ((b)'s adapters are added later); the odd
        # ranks make their first comparison after the steps, as every rank
        # did when the first chip run of phase 23 failed there with a
        # CUDA driver error in its torch.exp2 (ROADMAP.md queue 3)
        if rank % 2 == 0:
            res["kernels"] = train_kernels(ph, model)
            log(f"{ph.label} rank {rank}: K2/K3 held to their twins")
        got = train_steps(ph, cfg, model, mesh)
        log(f"{ph.label} rank {rank}: steps run, losses {got['ft_loss']!r} "
            f"/ {got['lora_loss']!r}")
        ref = torch.load(ref_path, map_location="cpu", weights_only=False)
        res["worst"] = {kind: train_hold(f"{ph.label} rank {rank}", got,
                                         ref, kind)
                        for kind in ("ft", "lora")}
        del ref
        for k in ("ft_loss", "lora_loss", "ft_leaves", "ft", "lora"):
            res[k] = got[k]
        res["lora_shapes"] = {k: tuple(v.shape)
                              for k, v in got["lora_new"].items()}
        del got
        if rank % 2 == 0:
            gc.collect()
            torch.cuda.empty_cache()
        else:
            res["exp2_probe"] = exp2_probe()
            log(f"{ph.label} rank {rank}: torch.exp2 after the steps (a "
                f"probe of the open fault; no path of the port calls it): "
                f"{res['exp2_probe']}")
        # after the steps (their adapters on, gloo's staging done); the
        # odd ranks straight after the holds, as that failed run did
        res["kernels_after"] = train_kernels(ph, model)
        log(f"{ph.label} rank {rank}: K2/K3 held to their twins after the "
            "steps")
        dist.barrier()
        if rank == 0:
            res["kernels_timed"] = train_kernels(ph, model, timed=True)
        dist.barrier()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def exp2_probe():
    """The process's first ``torch.exp2`` on the card ("ok", or the error
    it raised): PyTorch compiles that op at run time (NVRTC, its
    jiterator). Phase 23's first chip run failed in it after the steps
    (ROADMAP.md queue 3); the probe records whether it recurs, and the
    phase does not fail on it, since no path of the port calls it."""
    import torch
    try:
        x = torch.rand(1022, 2048, device="cuda") + 0.5
        torch.exp2(torch.floor(torch.log2(x)) - 7).sum().item()
        return "ok"
    except RuntimeError as e:
        return f"failed: {e}"


def phase_train_mesh(tag):
    """23 and 25: training under a mesh (above; module docstring): the
    one-rank references here, then four ranks, each held to them."""
    import gc
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from quip_for_all_tpu_torch.parallel.multihost import free_port
    ph = TRAIN_PHASES[tag]
    cfg = ph.cfg()
    L = cfg.num_hidden_layers
    t = time.time()
    model = ph.model(cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t
    ref = train_steps(ph, cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    one = {k: ref[k] for k in ("ft_loss", "lora_loss", "ft_leaves", "ft",
                               "lora")}
    log(f"{ph.label} one rank: built in {build_s:.1f} s; " + json.dumps(one)
        + f"; PYTORCH_CUDA_ALLOC_CONF="
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')!r}")

    def want(k2, k3):
        return {"ft": {}, "lora": {"fused_decode_matmul_tc": k2,
                                   "fused_decode_matmul_bwd": k3}}
    for kind, w in want(*ph.one_launches).items():
        if one[kind]["launches"] != w:
            raise AssertionError(f"{ph.label} one rank {kind}: launches "
                                 f"{one[kind]['launches']}, want {w}")
    out = tempfile.mkdtemp(prefix=f"train{tag}_")
    ref_path = os.path.join(out, "ref.pt")
    t = time.time()
    torch.save({k: {n: v.cpu() for n, v in ref[k].items()}
                for k in ("ft_grads", "ft_new", "lora_grads", "lora_new")},
               ref_path)
    save_s = time.time() - t
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    held_gib = torch.cuda.memory_reserved() / 2**30
    log(f"{ph.label}: {free_gib:.1f} GiB free on the card before the "
        f"ranks start, {held_gib:.2f} GiB reserved by this process")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      WORLD_SIZE=str(TRAIN_WORLD))
    t = time.time()
    try:
        # a rank that fails (or a check in it) makes spawn raise, and the
        # phase with it
        mp.spawn(train_rank, args=(tag, ref_path, out), nprocs=TRAIN_WORLD,
                 join=True)
    finally:
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
            os.environ.pop(k, None)
    ranks_s = time.time() - t
    rs = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
          for r in range(TRAIN_WORLD)]
    os.remove(ref_path)
    coll = ph.collectives(one["ft_leaves"], ph.ft_layers, L)
    summary = {"ranks": TRAIN_WORLD, "mesh": ph.mesh, "layers": L,
               "one_rank_build_s": build_s, "ref_save_s": save_s,
               "free_gib_before_ranks": free_gib,
               "parent_reserved_gib": held_gib,
               "ranks_wall_s": ranks_s, "one_rank": one,
               "collectives_counted": coll}
    for kind in ("ft", "lora"):
        losses = [res[f"{kind}_loss"] for res in rs]
        b = one[f"{kind}_loss"]
        if len(set(losses)) != 1 or not abs(losses[0] - b) <= (
                TRAIN_TOL * abs(b)):
            raise AssertionError(f"{ph.label} {kind}: the ranks' losses "
                                 f"{losses}, the one-rank step's {b}")
    for r, res in enumerate(rs):
        for kind, w in want(*rank_launches(ph)).items():
            if res[kind]["launches"] != w:
                raise AssertionError(f"{ph.label} rank {r} {kind}: launches "
                                     f"{res[kind]['launches']}, want {w}")
        summary[f"rank{r}"] = {
            k: res[k] for k in ("coords", "build_s", "free_gib", "worst",
                                "ft_leaves", "ft", "lora", "ft_loss",
                                "lora_loss")}
        summary[f"rank{r}"]["kernel_max_err"] = max(
            (row["max_abs_err"] for row in res.get("kernels", [])),
            default=None)
        summary[f"rank{r}"]["kernel_max_err_after_steps"] = max(
            row["max_abs_err"] for row in res["kernels_after"])
        summary[f"rank{r}"]["exp2_probe"] = res.get("exp2_probe")
        for kind in ("ft", "lora"):
            v = res[kind]
            (ge, gk), (ne, nk) = (res["worst"][kind]["grad"],
                                  res["worst"][kind]["new"])
            log(f"{ph.label} rank {r} at {res['coords']} {kind}: loss "
                f"{res[f'{kind}_loss']!r} (one rank "
                f"{one[f'{kind}_loss']!r}); worst gradient {ge:.3g} of its "
                f"max|grad| ({gk}), worst leaf after the step {ne:.3g} of "
                f"its max ({nk}; tol {TRAIN_TOL}); launches {v['launches']}"
                f"; collectives {v['collectives']} (counted "
                f"{coll[kind]}) taking "
                + ", ".join(f"{n} {s:.3f} s" for n, s in
                            v["collective_s"].items())
                + f"; step {v['s']:.2f} s (one rank {one[kind]['s']:.2f} s)"
                f"; peak {v['peak_gib']:.2f} GiB (one rank "
                f"{one[kind]['peak_gib']:.2f})")
        log(f"{ph.label} rank {r}: {res['ft_leaves']} finetune leaves (the "
            f"JAX package's {one['ft_leaves']}); adapters whole: "
            f"{len(res['lora_shapes'])} A/B; K2/K3 at its {len(ph.shapes)}"
            f" shapes, m = {ph.lora_b * (TRAIN_S - 1)}, max|k-plain| "
            f"{summary[f'rank{r}']['kernel_max_err']} before the steps, "
            f"{summary[f'rank{r}']['kernel_max_err_after_steps']} after;"
            f" built in "
            f"{res['build_s']:.1f} s, {res['free_gib']:.1f} GiB free after")
    rows = rs[0]["kernels_timed"]
    summary["kernel_rows"] = rows
    summary["kernel_sums"] = sums = train_sums(ph, rows)
    for kernel, s in sums.items():
        what = "LoRA forward" if kernel == "K2" else "LoRA step"
        n = rank_launches(ph)[0 if kernel == "K2" else 1]
        log(f"kernel {ph.label} {kernel} a rank's {what} ({n} calls at "
            f"m = {ph.lora_b * (TRAIN_S - 1)}, f32): " + ", ".join(
                f"{k} {v:.3f}" for k, v in s.items()))
    log(f"{ph.label}: {TRAIN_WORLD} ranks on one card (gloo, all on cuda:0)"
        f" measure training's correctness, launches and collectives under "
        f"a {' x '.join(f'{a} {n}' for a, n in ph.mesh.items())} mesh, not "
        f"its parallel speed; card {smi_line()}; ranks' wall "
        f"{ranks_s:.1f} s")
    return summary


def train_path_launches(entries, train, tag):
    """Phase ``tag``'s launches and per-call times beside K2's and K3's
    entries (rank 0's; four ranks on one card)."""
    ph = TRAIN_PHASES[tag]
    key = f"{ph.rank_key}_m{ph.lora_b * (TRAIN_S - 1)}"
    mesh = "_".join(f"{a}{n}" for a, n in ph.mesh.items() if n > 1)
    by = {e["name"]: e for e in entries}
    lora = train["rank0"]["lora"]["launches"]
    for name, kernel in (("fused_decode_matmul_tc", "K2"),
                         ("fused_decode_matmul_bwd", "K3")):
        e = by[name]
        e.setdefault("launches_by_path", {})[
            f"{mesh}_one_card_rank0_lora_step"] = lora[name]
        e[key] = {
            row["layer"]: {k: row[k] for k in (
                "q_out", "Gp", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
            for row in train["kernel_rows"] if row["kernel"] == kernel}
        e[f"{key}_sum"] = train[
            "kernel_sums"][kernel]


# Phase 24: the tools (ROADMAP queue 1 item 9) on the card
TOOLS_LEAVES = [("qkv", ("self_attn", "qkv_proj")), ("o", ("self_attn",
                                                          "o_proj")),
                ("gateup", ("mlp", "gateup_proj")),
                ("down", ("mlp", "down_proj")), ("head", None)]
TOOLS_M = (1, 8)
TOOLS_REPEATS = 3
TOOLS_MIX_LAYERS = 1
QUALITY_BAND = 0.03        # a cell's ppl against the port's own fp32 model
QUALITY_RECIPE_BAND = 0.10  # the port's fp32 model against the JAX run's


def tools_runs(tag, rep):
    """Log each variant-parity run of ``rep``: leaf, rows, variant, the
    function it reached, what it was held to and its max |diff|."""
    for r in rep.runs:
        log(f"{tag}: {r['leaf']} m={r['m']} {r['variant']}: {r['status']}; "
            f"reached {r['reached']}, held to {r['against']}, max |diff| "
            f"{r['max_abs_diff']:.4g} (scale {r['scale']:.4g}, tol "
            f"{0.05 * r['scale'] + 1e-3:.4g})")


def tools_sanitize_main(main):
    """(i) The sanitizer on the main path's model (phase 5's, full width,
    32 layers): determinism over TOOLS_REPEATS runs of the eager decode
    step and of the graphed step, both in bf16 from bf16 caches as the
    main path decodes, purity, finite logits; variant parity
    at m = 1 and 8 on layer 0's qkv, o, gate/up and down and on the head,
    each through K1 against ksplit = 2 (K6) and the dense decode."""
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.utils import sanitize as S
    cfg, model = main["cfg"], main["model"]
    qt.set_ksplit(model, 0)
    reset_launches()
    t = time.time()
    rep = S.sanitize_decode_step(cfg, model, repeats=TOOLS_REPEATS,
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    step_s = time.time() - t
    step_launches = {k: v for k, v in read_launches().items() if v}
    # eager: the repeats, the purity call and the finite call; graphed:
    # one warm-up (eager) and a replay a repeat (the capture takes back
    # what it counted)
    calls = TOOLS_REPEATS + 2 + 1 + TOOLS_REPEATS
    check_launches("24 (i) decode step", read_launches(),
                   {"fused_decode_matmul": (4 * LAYERS + 1) * calls})
    gen = torch.Generator(device="cuda").manual_seed(24)
    reset_launches()
    t = time.time()
    for name, path in TOOLS_LEAVES:
        leaf = model.lm_head if path is None else model.layers[0][
            path[0]][path[1]]
        for m in TOOLS_M:
            x = torch.randn((m, leaf.q_in), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            rep.merge(S.check_variant_parity(leaf.qweight, x, leaf=name))
    torch.cuda.synchronize()
    leaves_s = time.time() - t
    leaf_launches = {k: v for k, v in read_launches().items() if v}
    tools_runs("24 (i) variant parity", rep)
    for f in rep.skipped:
        log(f"24 (i) skipped: {f.leaf}: {f.detail}")
    log("24 (i) " + rep.summary().splitlines()[0])
    if not rep.ok:
        raise AssertionError("24 (i): sanitizer findings:\n" + rep.summary())
    bases = [r for r in rep.runs if r["variant"] == "base"]
    if not all(r["reached"].startswith("K1 ") for r in bases):
        raise AssertionError("24 (i): a base run did not reach K1: "
                             + json.dumps(bases))
    if not leaf_launches.get("ksplit_decode_matmul"):
        raise AssertionError("24 (i): no variant reached K6")
    log(f"24 (i) Llama-2-7B, {cfg.num_hidden_layers} layers: decode step "
        f"checks {step_s:.1f} s (launches {step_launches}); variant "
        f"parity on {len(TOOLS_LEAVES)} leaves at m = {TOOLS_M}: "
        f"{leaves_s:.1f} s, launches {leaf_launches}")
    return {"findings": len(rep.findings), "skipped": len(rep.skipped),
            "checks": sorted(set(rep.checks_run)), "runs": rep.runs,
            "step_launches": step_launches, "leaf_launches": leaf_launches,
            "step_s": step_s, "leaves_s": leaves_s}


def tools_stacked():
    """(ii) The sanitize CLI, ``--model mixtral_8x7b --layers
    TOOLS_MIX_LAYERS``, run as its ``main`` runs it (in this process, so
    that its launches count): Mixtral-8x7B at full width, experts
    stacked, seed 0; its bf16 decode step's checks and its sweep, one
    leaf per (codebook, layout, class), the stacked one (w13) through K4
    against each expert's dense decode."""
    import torch
    from quip_for_all_tpu_torch.tools import sanitize as T
    from quip_for_all_tpu_torch.utils.chiplock import chip_lock
    args = T.parse_args(["--model", "mixtral_8x7b", "--layers",
                         str(TOOLS_MIX_LAYERS)])
    reset_launches()
    t = time.time()
    with chip_lock(device=args.device):
        rep = T.run(args)
    torch.cuda.synchronize()
    run_s = time.time() - t
    launches = {k: v for k, v in read_launches().items() if v}
    tools_runs("24 (ii) Mixtral sweep", rep)
    log("24 (ii) " + rep.summary().splitlines()[0])
    kinds = {r["leaf"] for r in rep.runs}
    stacked = [r for r in rep.runs if "experts_stacked" in r["leaf"]]
    if not rep.ok or not stacked or not all(
            r["reached"].startswith("K4 ") for r in stacked):
        raise AssertionError("24 (ii): " + rep.summary() + "\n"
                             + json.dumps(rep.runs))
    if set(rep.checks_run) != {"determinism", "purity", "finite",
                               "variant_parity"}:
        raise AssertionError(f"24 (ii): checks run {rep.checks_run}")
    log(f"24 (ii) the sanitize CLI on Mixtral-8x7B, {TOOLS_MIX_LAYERS} "
        f"layer: {run_s:.1f} s with the build, the sweep over "
        f"{sorted(kinds)}; launches {launches}")
    torch.cuda.empty_cache()
    return {"runs": rep.runs, "launches": launches, "s": run_s,
            "skipped": len(rep.skipped)}


def tools_cli():
    """(iii) ``python -m quip_for_all_tpu_torch.tools.sanitize --model
    tiny`` as a subprocess on the card: exit code 0."""
    t = time.time()
    r = subprocess.run([sys.executable, "-m",
                        "quip_for_all_tpu_torch.tools.sanitize", "--model",
                        "tiny"], capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    s = time.time() - t
    for line in (r.stderr.strip().splitlines()[-12:]
                 + r.stdout.strip().splitlines()):
        log(f"24 (iii) | {line}")
    if r.returncode != 0:
        raise AssertionError(f"24 (iii): the sanitize CLI exited "
                             f"{r.returncode}")
    log(f"24 (iii) sanitize CLI --model tiny on the card: exit 0 in "
        f"{s:.1f} s")
    return {"rc": r.returncode, "s": s,
            "summary": r.stdout.strip().splitlines()[0]}


def tools_quality():
    """(iv) ``quality_matrix --fast`` on the card into a temporary
    directory: the E8P12 cell's two ppls within QUALITY_BAND of the port's
    own fp32 model's, the fp32 held-out ppl within QUALITY_RECIPE_BAND of
    the JAX run's (``docs/QUALITY.json`` main_fp32); then eval_ppl once
    more in this process on the cell's checkpoint, its ppl equal to the
    subprocess's and its K2 launches counted (every linear the widths rule
    sends to the kernels, once a batch of 8 x 32 rows)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from quip_for_all_tpu_torch.cli import eval_ppl
    from quip_for_all_tpu_torch.ops.fused_matmul import supports
    from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
    from quip_for_all_tpu_torch.tools import quality_matrix as Q
    from quip_for_all_tpu_torch.utils.checkpoint import load_quantized
    work = tempfile.mkdtemp(prefix="quality_")
    t = time.time()
    out = Q.main(["--fast", "--device", "cuda", "--workdir", work,
                  "--out", os.path.join(work, "QUALITY_TORCH.md")])
    s = time.time() - t
    with open(os.path.join(REPO, "docs", "QUALITY.json")) as f:
        jax_q = json.load(f)
    fp_h, fp_t = out["main_fp32"]
    _, _, q_h, q_t = out["main"][0]
    jfp_h, jfp_t = jax_q["main_fp32"]
    jq = {(c, v): (h, tt) for c, v, h, tt in jax_q["main"]}[("E8P12",
                                                               "base")]
    log(f"24 (iv) quality_matrix --fast on the card ({s:.1f} s): fp32 "
        f"held-out {fp_h} / train-window {fp_t} (JAX's CPU run {jfp_h} / "
        f"{jfp_t}); E8P12 held-out {q_h} / train-window {q_t} (JAX's "
        f"{jq[0]} / {jq[1]}); x fp32 {q_h / fp_h:.4f} / {q_t / fp_t:.4f}")
    if not (abs(q_h / fp_h - 1) <= QUALITY_BAND
            and abs(q_t / fp_t - 1) <= QUALITY_BAND):
        raise AssertionError(f"24 (iv): E8P12 ppl {q_h} / {q_t} more than "
                             f"{QUALITY_BAND:.0%} from fp32 {fp_h} / {fp_t}")
    if abs(fp_h / jfp_h - 1) > QUALITY_RECIPE_BAND:
        raise AssertionError(f"24 (iv): fp32 held-out ppl {fp_h}, more than "
                             f"{QUALITY_RECIPE_BAND:.0%} from JAX's {jfp_h}")
    ckpt = os.path.join(work, "main_E8P12_base")
    _, model, _ = load_quantized(ckpt, device="cuda")
    linears = sum(1 for m in model.modules()
                  if isinstance(m, QuantLinear) and supports(m.qweight))
    del model
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        eval_ppl.main(["--model-path", ckpt] + Q.eval_args(Q.EVAL_SEED)
                      + ["--device", "cuda"])
    launches = {k: v for k, v in read_launches().items() if v}
    ppl = json.loads(buf.getvalue().strip().splitlines()[-1])["ppl"]
    check_launches("24 (iv) eval_ppl in this process", read_launches(),
                   {"fused_decode_matmul_tc": 2 * linears})
    if round(ppl, 3) != q_h:
        raise AssertionError(f"24 (iv): eval_ppl here gave {ppl}, the "
                             f"subprocess {q_h}")
    shutil.rmtree(work)
    return {"s": s, "fp32": [fp_h, fp_t], "e8p12": [q_h, q_t],
            "jax_fp32": [jfp_h, jfp_t], "jax_e8p12": list(jq),
            "eval_launches": launches, "device": out["device"]}


def phase_tools(main):
    """24: the tools on the card (module docstring)."""
    res = {"sanitize_main": at("24 (i)", tools_sanitize_main, main),
           "stacked": at("24 (ii)", tools_stacked),
           "cli": at("24 (iii)", tools_cli),
           "quality": at("24 (iv)", tools_quality)}
    log(f"tools: card {smi_line()}")
    return res


def tools_path_launches(entries, tools):
    """Phase 24's launches beside K1's, K6's, K4's and K2's entries: (i),
    (ii) and (iv)'s eval_ppl in this process."""
    by = {e["name"]: e for e in entries}
    runs = (tools["sanitize_main"]["step_launches"],
            tools["sanitize_main"]["leaf_launches"],
            tools["stacked"]["launches"], tools["quality"]["eval_launches"])
    for name in ("fused_decode_matmul", "ksplit_decode_matmul",
                 "moe_decode_matmul", "fused_decode_matmul_tc"):
        by[name].setdefault("launches_by_path", {})["phase24_tools"] = sum(
            r.get(name, 0) for r in runs)


def at(phase, fn, *args):
    """Run one phase, logging when it starts and how long it took, so the
    script's time against its limit can be read phase by phase."""
    t = time.time()
    log(f"phase {phase}: starts at {t - T0:.1f} s")
    out = fn(*args)
    log(f"phase {phase}: took {time.time() - t:.1f} s")
    return out


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke run of the "
                                 "PyTorch port on one CUDA card.")
    ap.add_argument("--phase", action="append",
                    choices=("20", "21", "22", "23", "24", "25"),
                    help="run the kernels' build and this phase alone "
                    "(repeatable), print its summary and no result line")
    ap.add_argument("--profile-ft", action="store_true",
                    help="with --phase 21: the quantizer's finetune step "
                    "under torch.profiler, on one rank and on each "
                    "pipelined rank (its first call there under a host "
                    "stack sampler)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
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
        if args.phase:
            for ph in args.phase:
                out = (at(ph, phase_tp, args.profile_ft) if ph == "21"
                       else at(ph, phase_ep) if ph == "22"
                       else at(ph, phase_train_mesh, ph)
                       if ph in TRAIN_PHASES
                       else at(ph, phase_tools, dict(zip(
                           ("cfg", "model"), main_model())))
                       if ph == "24"
                       else at(ph, phase_lora_families))
                log(f"phase {ph}: " + json.dumps(out, default=str))
            return 0
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
        # before phase 12, which cuts the main path's model to its first
        # PATH12_LAYERS blocks
        tools = at("24", phase_tools, main)
        new_paths = at("12", phase_layout_paths, main)
        mix = at("6", phase_mixtral)
        neox = at("18 (i)", phase_neox20b)
        fams = at("18 (ii)", phase_families)
        paths = at("9", phase_rowpair_paths)
        train = at("14", phase_train)
        lora = at("20", phase_lora_families)
        quant = at("19", phase_quantize)
        tp = at("21", phase_tp)
        ep = at("22", phase_ep)
        train_mesh = at("23", phase_train_mesh, "23")
        train_ep = at("25", phase_train_mesh, "25")
        entries = kernel_entries(rows, max_err, moe_rows, moe_err, launches,
                                 mix, rp_rows, rp_err, paths)
        entries += layout_entries(lay_rows, lay_err, new_paths)
        entries.append(k3_entry(k3_rows, k3_err, train))
        entries.append(k2_entry(k2_rows, k2_err, train))
        lora_entry(entries[-2], k3_rows, LORA_K3_CALLS, lora, "step")
        lora_entry(entries[-1], k2_rows, LORA_K2_CALLS, lora, "forward")
        entries += microbench_entries(mb_recs)
        right_entries(entries, right_rows)
        serving_path_launches(entries, graphed, serving, mix)
        family_path_launches(entries, neox, fams)
        quant_path_launches(entries, quant)
        tp_path_launches(entries, tp)
        ep_path_launches(entries, ep)
        train_path_launches(entries, train_mesh, "23")
        train_path_launches(entries, train_ep, "25")
        tools_path_launches(entries, tools)
        log("right epilogue and combined decode: " + json.dumps({
            "main_path": right_main,
            "rvq4b_nibble_both": paths["c_rvq4b_nibble"]["right_combine"]}))
        log("families: " + json.dumps({"gpt_neox_20b": neox,
                                        "published_widths": fams}))
        log("quantization: " + json.dumps(quant))
        log("lora on the families: " + json.dumps(lora))
        log("tensor parallelism: " + json.dumps(tp))
        log("expert parallelism: " + json.dumps(ep, default=str))
        log("training under a mesh: " + json.dumps(train_mesh, default=str))
        log("training over the expert axis: " + json.dumps(train_ep,
                                                           default=str))
        log("tools: " + json.dumps(tools, default=str))
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
