"""Training: hand-written AdamW and SGD-momentum over the parameters under
the reference's names, int8 error-feedback gradient compression,
checkpoints in the reference's on-disk format, and the training loop with
gradient accumulation, periodic and on-signal checkpoints and
deterministic resume."""
