"""Fused decode+matmul (CUDA kernels and plain twins: nibble layout in
``fused_matmul``, row-pair u3/pb layouts in ``rowpair_matmul``, MoE in
``moe_matmul``), dense decode, dispatch and the QuantizedTensor."""
