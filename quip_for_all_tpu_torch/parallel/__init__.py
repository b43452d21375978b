"""Parallelism over ``torch.distributed`` — counterpart of
``quip_for_all_tpu/parallel/``: tensor and expert parallelism
(``sharding.py``: the meshes, the megatron role rules, ``shard_params``;
``layers.py``: a rank's column- and row-parallel linears and its
expert-parallel MoE block), sequence parallelism (``sequence.py``: ring
attention, ``sequence_parallel_logits``), the GPipe pipeline
(``pipeline.py``: ``pipeline_logits``, differentiable for the pipelined
finetune), multihost (``multihost.py``: joining the group, the hybrid
mesh) and ``comm.py`` (every collective they run, counted).

The modules import nothing at package import, so ``models/`` can import
``parallel.layers`` without a cycle.
"""
