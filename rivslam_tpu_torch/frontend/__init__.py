"""Scan registration of the PyTorch port."""
