"""Command-line entry points of the port (quantize, generate, eval_ppl,
finetune_lora)."""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def rank_group(n: int, flag: str, device: str):
    """The process group that a CLI's ``flag`` of ``n`` ranks runs over:
    the initialised one, or else one joined from the standard environment
    variables (``torchrun --nproc-per-node n`` sets them: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) on gloo, which takes CPU and CUDA
    tensors and lets two ranks share one card, and left when the block
    ends. Raises when the world size is not ``n``. On the card a rank
    takes card LOCAL_RANK modulo the card count. Yields this rank's
    global rank."""
    import torch
    import torch.distributed as dist
    joined = not dist.is_initialized()
    if joined:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"{flag} {n} runs on {n} ranks: start it under torchrun "
                f"--nproc-per-node {n}, or initialise a process group")
        dist.init_process_group("gloo", init_method="env://")
    try:
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"{flag} {n} needs a world of {n} ranks, not "
                             f"{world}")
        if torch.device(device).type == "cuda" and torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            torch.cuda.set_device(local % torch.cuda.device_count())
        yield dist.get_rank()
    finally:
        if joined:
            dist.destroy_process_group()
