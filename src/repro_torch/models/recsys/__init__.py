"""Recsys models of the port (``repro.models.recsys``): Wide & Deep over
per-field embedding tables."""
