"""Blockwise (flash) attention for the LM prefill: a hand-written CUDA
kernel (`csrc/flash_attention.cu`) and its plain version (`ref.py`)."""
