"""Data sources of the PyTorch port."""
