"""MinkowskiUNet (the paper's own SparseConv benchmark, MinkNet(i)/(o)).

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="minkunet", family="pointcloud",
        n_layers=8, d_model=32, vocab_size=0,
        notes="sparse conv U-Net; enc (32,64,128,256) dec (256,128,96,96)",
    ),
    reduced=ArchConfig(
        name="minkunet", family="pointcloud",
        n_layers=4, d_model=8,
        notes="enc (8,16) dec (16,8)",
    ),
)
