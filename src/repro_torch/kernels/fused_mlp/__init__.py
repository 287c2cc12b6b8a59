"""Temporal layer fusion: a chain of dense layers in one kernel launch."""
