"""Sharded execution over torch.distributed: the sharding rules, the GPipe
pipeline and the compressed cross-pod gradient exchange."""
