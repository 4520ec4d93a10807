"""Training/serving substrate: optimizer, train step, checkpointing and the
serving step."""
