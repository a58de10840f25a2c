"""Architecture registry of the port — the dense family's four configs, the
MoE family's two, the SSM family's mamba2-130m and the hybrid family's
jamba-v0.1-52b.

``get_config(name)`` returns the full published config; ``get_smoke_config``
returns a reduced same-family config for CPU tests.  ``--arch <id>`` in the
launchers resolves through this registry.  The other architectures of the
JAX package register here as their model families are ported.
"""
from .base import ModelConfig, get_config, get_smoke_config, list_archs, register

# importing the modules registers the configs
from . import (granite_3_2b, granite_34b, granite_moe_1b_a400m,  # noqa: F401
               jamba_v0_1_52b, mamba2_130m, olmo_1b, qwen2_1_5b,
               qwen2_moe_a2_7b)

ARCHS = list_archs()

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register", "ARCHS"]
