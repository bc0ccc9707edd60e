"""Optimizers of the port: AdamW with an int8-compressed second moment."""
