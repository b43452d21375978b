"""Command-line entry points of the port (quantize, generate, eval_ppl,
finetune_lora)."""
