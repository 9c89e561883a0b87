"""Point operations of the PyTorch port: plain torch, and the hand-written
CUDA kernels with their plain twins."""
