"""Command-line entry points of the port (``finetune_lora``)."""
