"""PyTorch / CUDA port of the SPA-Cache decode (H100, ``sm_90a``).

The package mirrors ``repro``'s layout (``configs``, ``models``, ``core``,
``kernels``, ``dlm``) and imports nothing of it: the JAX package is the
reference the tests hold this one against.  The hot-path stages of a SPA
layer step run through hand-written CUDA kernels (``csrc/``, built at first
use by ``kernels/_lib.py``) on the card, and through their plain PyTorch
versions on the CPU.
"""
