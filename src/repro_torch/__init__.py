"""repro_torch — the PyTorch/CUDA port of the ``repro`` scheduling system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``platform``, ``core``, ``streams``, ``serve``,
``kernels``, ``models``, ``launch``) and imports nothing of it.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; asking for
``cuda`` on a host without a card raises (``repro_torch.device``).

Importing the package imports no torch: the host-only modules (``core``,
``platform``, ``obs``, the simulator's planners) load without it, so the
campaign's planning workers start without paying torch's import.
"""
__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
