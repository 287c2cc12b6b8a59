"""Synthetic inputs (`synthetic`) and the host-side prefetching pipeline
(`pipeline`)."""
