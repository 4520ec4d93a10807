"""Serving substrate (``serve_step``).  The training half -- optimizer, train
step, checkpointing -- is ROADMAP Queue 1 item 15, part two."""
