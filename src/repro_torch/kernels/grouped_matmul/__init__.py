"""Sorted MoE dispatch and the per-expert grouped matmul: two hand-written
CUDA kernels (`csrc/grouped_matmul_wgmma.cu` on the tensor cores for bf16,
`csrc/grouped_matmul.cu` with float32 FMAs for the rest), two for its
weight gradient (`csrc/grouped_matmul_dw_wgmma.cu`, `csrc/grouped_matmul_dw.cu`,
split the same way), and their plain versions."""
