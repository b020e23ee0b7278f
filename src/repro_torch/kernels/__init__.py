"""Hand-written Hopper kernels of the PyTorch port, one package per family:
``dbs`` (block-device write, read and copy), ``paged_attention``,
``flash_attention`` and ``rwkv6_scan``."""
