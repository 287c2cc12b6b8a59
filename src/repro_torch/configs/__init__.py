"""Architecture configs of the port (the ported subset of `repro.configs`)."""

from repro_torch.configs.base import ArchConfig, get, list_archs, register

__all__ = ["ArchConfig", "get", "list_archs", "register"]
