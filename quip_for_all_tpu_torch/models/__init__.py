"""Model configs and the llama-family decoder."""
