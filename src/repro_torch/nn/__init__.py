"""nn (PyTorch port)."""
