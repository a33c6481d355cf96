"""Checkpointing of the port's training state (``repro.checkpoint``)."""
