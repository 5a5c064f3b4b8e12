"""dmlp_tpu_torch — the PyTorch / CUDA port of dmlp_tpu.

The distributed brute-force KNN classifier of ``dmlp_tpu``, ported to
PyTorch with its TPU kernels rewritten by hand in CUDA C++ for Hopper
(``sm_90a``). The package imports torch, numpy and the standard library
only; ``dmlp_tpu`` stays the reference it is held against.
"""
