"""Optimizers (PyTorch port)."""
