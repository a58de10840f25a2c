"""Architecture registry of the port — every architecture of the JAX
package's: the dense family's four configs, the MoE family's two, the SSM
family's mamba2-130m, the hybrid family's jamba-v0.1-52b, the
encoder-decoder's whisper-medium and the vision-language internvl2-76b.

``get_config(name)`` returns the full published config; ``get_smoke_config``
returns a reduced same-family config for CPU tests.  ``--arch <id>`` in the
launchers resolves through this registry.
"""
from .base import ModelConfig, get_config, get_smoke_config, list_archs, register

# importing the modules registers the configs
from . import (granite_3_2b, granite_34b, granite_moe_1b_a400m,  # noqa: F401
               internvl2_76b, jamba_v0_1_52b, mamba2_130m, olmo_1b,
               qwen2_1_5b, qwen2_moe_a2_7b, whisper_medium)

ARCHS = list_archs()

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register", "ARCHS"]
