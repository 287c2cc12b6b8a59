"""Mini-MinkowskiUNet: the paper's co-designed light model (Fig. 16).

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mini-minkunet", family="pointcloud",
        n_layers=4, d_model=16,
        notes="paper §5.2.2 co-design: shallow/narrow MinkowskiUNet",
    ),
    reduced=ArchConfig(
        name="mini-minkunet", family="pointcloud",
        n_layers=4, d_model=8,
    ),
)
