"""The port's microbenchmarks: counterparts of the JAX package's
``tools/microbench_{kernel,decode,split,tn,bfp}.py`` (T1-T5), each with a
hand-written CUDA kernel or one of the port's decode kernels, a plain torch
twin per variant, and a ``main()`` that prints one JSON line per variant.

    python -m quip_for_all_tpu_torch.tools.microbench_kernel --N 4096 --K 4096 --m 8

Each entry point runs on the card unless given ``--device cpu``, where the
twins run and nothing is timed. Nothing is written to disk."""
