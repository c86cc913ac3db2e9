"""flash_attention (PyTorch port)."""
