"""Training on one card: AdamW, the train step, error feedback and the
two-tier checkpoints."""
