"""Training: AdamW, the train step and gradient compression."""
