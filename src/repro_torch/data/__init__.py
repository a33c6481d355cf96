"""Data of the port's training loop (``repro.data``): (seed, step)
deterministic synthetic batches and the prefetching pipeline."""
