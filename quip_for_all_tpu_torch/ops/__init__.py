"""Fused decode+matmul (CUDA kernels and plain twins: nibble layout and the
dispatch by layout in ``fused_matmul``, bfp / sw / split-K in
``layout_matmul``, u3 / pb / paired in ``rowpair_matmul``, MoE in
``moe_matmul``), dense decode and the QuantizedTensor."""
