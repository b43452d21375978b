"""Quantized linear layers."""
