"""Synthetic input scenes."""
