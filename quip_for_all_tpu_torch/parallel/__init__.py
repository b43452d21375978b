"""Parallelism over ``torch.distributed`` — counterpart of
``quip_for_all_tpu/parallel/``: tensor parallelism (``sharding.py``: the
meshes, the megatron role rules, ``shard_params``; ``layers.py``: a rank's
column- and row-parallel linears), sequence parallelism (``sequence.py``:
ring attention, ``sequence_parallel_logits``), the GPipe pipeline
(``pipeline.py``: ``pipeline_logits``, differentiable for the pipelined
finetune) and ``comm.py`` (every collective they run, counted). The
expert axis and multihost (ROADMAP.md queue 1 item 8c) are not ported
yet.

The modules import nothing at package import, so ``models/`` can import
``parallel.layers`` without a cycle.
"""
