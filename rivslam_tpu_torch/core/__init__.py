"""Configuration, point clouds and Lie-group math of the PyTorch port."""
