"""bitdance_tpu_torch: the PyTorch + CUDA port of bitdance_tpu for one NVIDIA H100.

Mirrors the layout of ``bitdance_tpu`` (ops, models, pipelines, io) with the
same module and function names where the function is the same. Plain tensor
code is PyTorch; the TPU's Pallas kernels on the serving path are CUDA C++
kernels for sm_90a under ``csrc/``, built at first use (``ops/_cuda.py``).
The package imports no JAX and nothing of ``bitdance_tpu``.
"""

__version__ = "0.1.0"
