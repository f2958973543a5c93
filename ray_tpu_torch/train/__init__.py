"""The training fast path: ``StepDriver``, its config and checkpoints."""
