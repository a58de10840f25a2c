"""The contention fixpoint (max-min fair fluid transfers against a float64
replay): ``ref.py`` holds the plain versions, ``contention.py`` the
wrapper of the CUDA kernel ``csrc/contention_sm90.cu``."""
