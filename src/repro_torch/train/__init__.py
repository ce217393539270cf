"""The training substrate: AdamW, gradient compression, checkpoints."""
