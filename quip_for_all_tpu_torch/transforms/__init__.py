"""Incoherence transforms and Hadamard tables."""
