"""quip_for_all_tpu_torch: the PyTorch / CUDA (Hopper) port of
quip_for_all_tpu, slice by slice (ROADMAP.md). Imports torch and numpy,
never JAX or the JAX package. Entry points run on the card unless the
caller passes device="cpu".
"""
from .models.config import ModelConfig, llama2_7b_config, tiny_config
from .models.llama import (fuse_for_inference, set_combine_planes,
                           set_ksplit, set_right_in_kernel)
from .runtime.generate import generate, generate_stream, perplexity
from .runtime.serving import ServingEngine
from .utils.checkpoint import load_quantized
from .utils.convert import from_jax_params
from .utils.random_quantized import random_quantized_model

__all__ = ["ModelConfig", "llama2_7b_config", "tiny_config",
           "fuse_for_inference", "set_ksplit", "set_right_in_kernel",
           "set_combine_planes", "generate",
           "generate_stream", "perplexity", "ServingEngine",
           "load_quantized", "from_jax_params", "random_quantized_model"]
