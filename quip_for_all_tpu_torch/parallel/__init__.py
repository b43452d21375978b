"""Parallelism over ``torch.distributed`` — counterpart of
``quip_for_all_tpu/parallel/``. Tensor parallelism so far:
``sharding.py`` (the mesh, the megatron role rules, ``shard_params``),
``layers.py`` (a rank's column- and row-parallel linears) and ``comm.py``
(every collective they run, counted). Sequence parallelism and the
pipeline (ROADMAP.md queue 1 item 8b) and the expert axis and multihost
(item 8c) are not ported yet.

The modules import nothing at package import, so ``models/`` can import
``parallel.layers`` without a cycle.
"""
