"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

``stat_counts`` (K1) and ``multi_threshold`` (K2): each wrapper launches its kernel for
CUDA tensors and runs the plain version for CPU tensors, and counts its launches in
the module's ``LAUNCHES``. The kernels build at first use (``_build``).
"""
