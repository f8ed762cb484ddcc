"""PyTorch port of the ``repro`` model and serving stack for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``distrib``, ``models``, ``kernels``, ``runtime``,
``launch``) and imports nothing from it.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; see :func:`resolve_device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
