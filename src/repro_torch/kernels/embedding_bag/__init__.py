"""embedding_bag (PyTorch port)."""
