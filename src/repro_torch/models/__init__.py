"""Sparse-conv models."""
