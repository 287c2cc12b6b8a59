"""LM training on one card: losses, AdamW and the train step."""
