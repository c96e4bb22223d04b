"""SIFT frontend of the PyTorch port (lowe mode)."""
