"""Training loop and checkpoints (PyTorch port)."""
