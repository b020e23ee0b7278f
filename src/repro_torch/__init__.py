"""PyTorch/CUDA port of the Longhorn engine reproduction in ``repro``.

The package mirrors ``repro`` module for module and imports neither JAX nor
any ``repro`` module. Its entry points run on a CUDA device unless the
caller passes ``device="cpu"``; its kernels are written by hand for Hopper
(``kernels/dbs/csrc``). ``repro_torch.core.blockdev.VolumeManager`` is the
public block device.
"""
