"""Sorted MoE dispatch and the per-expert grouped matmul: two hand-written
CUDA kernels (`csrc/grouped_matmul_wgmma.cu` on the tensor cores for bf16,
`csrc/grouped_matmul.cu` with float32 FMAs for the rest) and their plain
version."""
