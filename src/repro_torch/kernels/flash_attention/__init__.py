"""Blockwise (flash) attention for the LM prefill: two hand-written CUDA
kernels (`csrc/flash_attention_wgmma.cu` on the tensor cores for bf16,
`csrc/flash_attention.cu` on float32 FMAs for the rest) and their plain
versions (`ref.py`)."""
