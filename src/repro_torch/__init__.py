"""repro_torch — the PyTorch/CUDA port of the ``repro`` scheduling system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``platform``, ``core``, ``streams``, ``serve``,
``kernels``, ``models``, ``launch``) and imports nothing of it.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; asking for
``cuda`` on a host without a card raises (``repro_torch.device``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
