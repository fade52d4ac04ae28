"""Training substrate of the port: `optim` (AdamW, schedules, clipping,
int8 compression), `checkpoint` (atomic, resumable), `loop` (step factory
and driver), `pytree` (the tree walks they share)."""
