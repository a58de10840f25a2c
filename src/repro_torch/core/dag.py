"""Resource-type indices of the paper's hybrid (CPU, GPU) platform.

For the hybrid case Q=2 with the convention q=0 -> CPU (p-bar),
q=1 -> GPU (p-underbar), matching the paper's notation.  ``TaskGraph``
ports with the simulation slice.
"""
from __future__ import annotations

CPU, GPU = 0, 1  # resource-type indices for the hybrid (Q=2) case
