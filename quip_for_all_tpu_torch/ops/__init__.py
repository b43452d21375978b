"""Fused decode+matmul (CUDA kernel and plain twin), dense decode,
dispatch and the nibble-layout QuantizedTensor."""
