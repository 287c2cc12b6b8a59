"""Packed keys, mapping, sparse conv flows and SparseTensor state."""
