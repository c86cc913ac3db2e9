"""fm_interaction (PyTorch port)."""
