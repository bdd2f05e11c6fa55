"""Model parameters, layers, attention and the trunk, for attention-only
dense models on one card."""
