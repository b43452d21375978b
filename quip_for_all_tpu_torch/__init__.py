"""quip_for_all_tpu_torch: the PyTorch / CUDA (Hopper) port of
quip_for_all_tpu, slice by slice (ROADMAP.md). Imports torch and numpy,
never JAX or the JAX package. Entry points run on the card unless the
caller passes device="cpu".
"""
from .codebooks import codebook_id, get_codebook
from .models.config import ModelConfig, llama2_7b_config, tiny_config
from .models.llama import (init_llama_params, set_combine_planes,
                           set_ksplit, set_moe_dense_stacked,
                           set_right_in_kernel)
from .models.registry import fuse_for_inference, get_arch
from .runtime.generate import generate, generate_stream, perplexity
from .runtime.serving import ServingEngine
from .quantize.quantizer import QuipQuantizer
from .utils.checkpoint import load_quantized, save_quantized
from .utils.convert import from_jax_params
from .utils.hf_import import load_hf_model, save_hf_model
from .utils.random_quantized import random_quantized_model

# the JAX package's (and its reference's) alias
load_quantized_model = load_quantized

__all__ = ["ModelConfig", "QuipQuantizer", "codebook_id", "get_codebook",
           "init_llama_params", "load_hf_model", "save_hf_model",
           "save_quantized", "load_quantized_model",
           "llama2_7b_config", "tiny_config",
           "fuse_for_inference", "get_arch", "set_ksplit",
           "set_right_in_kernel", "set_combine_planes",
           "set_moe_dense_stacked", "generate",
           "generate_stream", "perplexity", "ServingEngine",
           "load_quantized", "from_jax_params", "random_quantized_model"]
