"""Fetch-on-demand sparse convolution kernels."""
