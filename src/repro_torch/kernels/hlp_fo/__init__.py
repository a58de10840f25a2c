"""The first-order LP's Adam-on-logits solves: ``ref.py`` holds the plain
versions, ``hlp_fo.py`` the wrapper of the CUDA kernel
``csrc/hlp_fo_sm90.cu``."""
