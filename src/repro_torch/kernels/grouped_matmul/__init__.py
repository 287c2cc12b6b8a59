"""Sorted MoE dispatch and the per-expert grouped matmul: a hand-written
CUDA kernel (`csrc/grouped_matmul.cu`) and its plain version."""
