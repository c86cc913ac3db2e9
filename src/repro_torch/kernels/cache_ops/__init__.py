"""cache_ops (PyTorch port)."""
