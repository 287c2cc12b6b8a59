"""Architecture configs of the port: every config of the reference's
`configs` (granite-moe-1b-a400m, qwen1.5-4b, qwen1.5-32b, granite-34b,
mixtral-8x7b, jamba-v0.1-52b, xlstm-125m, gemma2-2b, qwen2-vl-72b,
seamless-m4t-medium, minkunet, mini-minkunet)."""

from repro_torch.configs.base import ArchConfig, get, list_archs, register

__all__ = ["ArchConfig", "get", "list_archs", "register"]
