"""Training over a frozen quantized model (LoRA adapters)."""
