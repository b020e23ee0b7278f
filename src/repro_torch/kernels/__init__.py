"""Hand-written Hopper kernels of the PyTorch port, one package per family."""
