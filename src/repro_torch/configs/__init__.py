"""Architecture registry of the port — the dense configs it serves so far.

``get_config(name)`` returns the full published config; ``get_smoke_config``
returns a reduced same-family config for CPU tests.  ``--arch <id>`` in the
launchers resolves through this registry.  The other architectures of the
JAX package register here as their model families are ported.
"""
from .base import ModelConfig, get_config, get_smoke_config, list_archs, register

# importing the modules registers the configs
from . import granite_3_2b, qwen2_1_5b  # noqa: F401

ARCHS = list_archs()

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register", "ARCHS"]
