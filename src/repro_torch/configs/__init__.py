"""Architecture configs of the port (the ported subset of the reference's
`configs`: granite-moe-1b-a400m, qwen1.5-4b, qwen1.5-32b, granite-34b,
mixtral-8x7b, jamba-v0.1-52b, xlstm-125m, gemma2-2b, minkunet,
mini-minkunet)."""

from repro_torch.configs.base import ArchConfig, get, list_archs, register

__all__ = ["ArchConfig", "get", "list_archs", "register"]
