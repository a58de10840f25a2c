"""The contention fixpoint (max-min fair fluid transfers against a float64
replay): ``ref.py`` holds the plain versions, ``contention.py`` the
wrappers of the CUDA kernels ``csrc/contention_sm90.cu`` (the card path's
default) and ``csrc/contention.cu`` (the first port, when asked)."""
