"""Serving: point clouds (`engine`) and token LMs (`lm`)."""
