"""Single-token attention over a KV cache for the LM decode step: a
hand-written CUDA kernel (`csrc/flash_decode.cu`) and its plain version."""
