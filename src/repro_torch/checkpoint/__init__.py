"""Checkpointing (atomic promote, keep-last-k, template and
template-free restore), ported from ``repro.checkpoint``."""
