"""Checkpoints of the training launcher: atomic, resumable, in the
reference's on-disk format (`store`)."""
