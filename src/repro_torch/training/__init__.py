"""Training substrate of the port (``repro.training``): the train-step
factory, AdamW with its schedules, and gradient compression."""
