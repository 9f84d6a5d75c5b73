"""Entry points of the port's model path (serving and training)."""
